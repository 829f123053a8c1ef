"""The FL language-model path: ``FedS3ATrainer(data,
FedS3AConfig(model=<qwen2 ModelConfig>))`` on the port's sequential and
batched engines on the CPU, against the reference's SEQUENTIAL engine
(``use_kernels=False``), from the reference's own initial LM parameters
exported leaf by leaf, on the same numpy data.

Model: qwen2-1.5b cut to ``benchmarks/bench_fleet.py``'s ``lm-small``
shape (1 layer, d 128, d_ff 256, 2 heads), V = 512, float32. Data:
``make_lm_dataset(8, vocab_size=512, seq_len=16, num_classes=8)``,
batch 16, lr 5e-4, 2 rounds; on both engines csr, csr_q + EF,
dense_masked with and without EF, the disabled channel, fp16 csr_q with
and without EF (and with 2 epochs) and csr over 2 epochs; csr + EF
batched. With every nonzero element sent (an absolute threshold) the
bounds are the reference's own cross-engine ones
(tests/test_engine_parity.py:125, :136): schedules, stalenesses, forced
sets, base versions, message counts and dense bytes exact; parameters atol
1e-4 / rtol 1e-3 (over 2 epochs with ``EPOCHS_OUTSIDE`` exceptions);
metrics 1e-4; ACO 2e-3. At the default p0.2 the schedules and metrics are
held the same way, the ACO and parameters at what threshold ties allow
(``test_p02_ties_amplify_ulps``). Also the disabled channel's ledger
against the reference's, the flat order of the reduced qwen2 tree against
``jax.tree.leaves``, leaf by leaf, and the refusals."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import load_all as jload_all  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.core import sparse_comm as jcomm  # noqa: E402
from repro.core.param_layout import leaf_sizes as j_leaf_sizes  # noqa: E402
from repro.data.synthetic_lm import make_lm_dataset as j_make_lm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, load_all  # noqa: E402
from repro_torch.core import param_layout, sparse_comm  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_lm_dataset  # noqa: E402
from repro_torch.tree import leaves_with_path, path_name  # noqa: E402
from repro_torch.weights import params_to_numpy, tree_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LM_SMALL = dict(num_layers=1, d_model=128, d_ff=256, num_heads=2,
                num_kv_heads=1, dtype="float32")
DATA = dict(vocab_size=512, seq_len=16, num_classes=8)
RUN = dict(rounds=2, batch_size=16, lr=5e-4, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread a process: the suite runs in several worker
    processes at once, and more threads than cores only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    jload_all()
    load_all()
    return (jget_config("qwen2-1.5b").reduced(**LM_SMALL, **kw),
            get_config("qwen2-1.5b").reduced(**LM_SMALL, **kw))


def _init(jcfg, seed=0):
    """The reference trainer's initial LM parameters (the second half of
    split(PRNGKey(seed))), leaf by leaf as numpy."""
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, jlm.init_params(jcfg, k))


_REFERENCE = {}


def _reference(wire):
    """The reference's sequential run on ``wire`` (csr, or csr_q + EF) at
    the sparse threshold ``thr``, made once a module."""
    key = tuple(sorted(wire.items()))
    if key not in _REFERENCE:
        jcfg, _ = _cfgs()
        tr = JTrainer(j_make_lm(8, **DATA),
                      JConfig(model=jcfg, engine="sequential",
                              use_kernels=False, **dict(RUN, **wire)))
        _REFERENCE[key] = (tr, tr.train())
    return _REFERENCE[key]


def _port(engine, wire):
    jcfg, cfg = _cfgs()
    tr = FedS3ATrainer(make_lm_dataset(8, **DATA),
                       FedS3AConfig(model=cfg, device="cpu", engine=engine,
                                    **dict(RUN, **wire)),
                       init_params=_init(jcfg))
    return tr, tr.train()


EF = dict(error_feedback=True)
CSRQ_EF = dict(wire_format="csr_q", error_feedback=True)
DENSE_MASKED = dict(wire_format="dense_masked")
FP16 = dict(wire_format="csr_q", q_dtype="fp16")
OPTIONS = {"dense-masked": DENSE_MASKED,
           "dense-masked-ef": dict(DENSE_MASKED, **EF),
           "disabled": dict(sparse_comm=False),
           "fp16": FP16,
           "fp16-ef": dict(FP16, **EF),
           "fp16-ef-epochs-2": dict(FP16, epochs=2, **EF),
           "epochs-2": dict(epochs=2)}
CASES = {"sequential-csr": ("sequential", {}),
         "batched-csr": ("batched", {}),
         "batched-csr-ef": ("batched", EF),
         "sequential-csrq-ef": ("sequential", CSRQ_EF),
         "batched-csrq-ef": ("batched", CSRQ_EF),
         **{f"{engine}-{name}": (engine, wire) for name, wire in
            OPTIONS.items() for engine in ("sequential", "batched")}}
# an absolute threshold below every update keeps each nonzero element: the
# payloads then hold no threshold ties (see test_p02_ties_amplify_ulps)
EXACT_KEEP = 1e-6
# Over 2 epochs a few parameters pass atol 1e-4 / rtol 1e-3 even at
# EXACT_KEEP, each within two Adam steps (2 lr): with twice the steps an
# embedding entry that the L1 term walks across zero takes a step of about
# lr one way or the other by an ulp of its gradient. Measured (csr, one
# intra-op thread): 1 of 213,248 outside on either engine (embed[369, 31],
# 1.13e-4 from the reference's); the port against itself with lr moved 2
# ulps 8.5e-5 apart; the reference's two engines 2.4e-7 apart (they share
# one jitted Adam); the allowance is that measurement and one more
EPOCHS_OUTSIDE = 2


def _same_schedule(port, ref):
    assert len(port.logs) == len(ref.logs) == RUN["rounds"]
    for a, b in zip(port.logs, ref.logs):
        assert (a.round, a.participants, a.stalenesses, a.forced, a.time,
                a.art) == (b.round, b.participants, b.stalenesses, b.forced,
                           b.time, b.art)
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)


def _max_param_diff(port, ref, atol, rtol, outside=0):
    """Every parameter within atol / rtol of the reference's but for at
    most ``outside`` of them, each within two Adam steps (2 lr)."""
    jp = jax.tree_util.tree_flatten_with_path(ref.global_params)[0]
    tp = leaves_with_path(params_to_numpy(port.global_params))
    assert len(jp) == len(tp)
    past = []
    for (_, jv), (path, v) in zip(jp, tp):
        jv = np.asarray(jv)
        assert v.shape == jv.shape, path_name(path)
        gap = np.abs(v - jv)
        # a NaN compares False: counted outside, as assert_allclose fails it
        past += [(path_name(path), float(d))
                 for d in gap[~(gap <= atol + rtol * np.abs(jv))]]
    assert len(past) <= outside and \
        all(d <= 2 * RUN["lr"] for _, d in past), past[:8]


@pytest.mark.parametrize("case", list(CASES))
def test_lm_trainer_matches_reference_sequential(case):
    """Every element that changes is sent: the cross-engine bounds."""
    engine, wire = CASES[case]
    wire = dict(wire, sparse_threshold=EXACT_KEEP)
    ref, want = _reference(wire)
    port, got = _port(engine, wire)
    assert port.adapter.kind == "lm" and port.adapter.num_classes == 512
    assert port.engine == engine
    _same_schedule(port, ref)
    _max_param_diff(port, ref, atol=1e-4, rtol=1e-3,
                    outside=EPOCHS_OUTSIDE if "epochs" in wire else 0)
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-4, m
    assert abs(got["aco"] - want["aco"]) < 2e-3
    assert got["fleet"] == want["fleet"] and got["art"] == want["art"]
    # the framing: as many messages, of as many parameters
    assert port.comm.messages == ref.comm.messages
    assert port.comm.dense_bytes == ref.comm.dense_bytes


# p0.2: the reference's default sparsity. Schedules, versions and metrics
# are held as above; the ACO and the parameters at what the threshold ties
# allow: port against reference, measured at -0.0697 (csr) and -0.0264
# (csr_q + EF) in ACO and 3.02e-3 in the parameters, the reference's own
# two engines 2.9e-6 apart; on the other options (tests/reference_spread.py
# --cell lm, one intra-op thread) -0.0695 (dense_masked), -0.0679
# (dense_masked + EF), -0.0347 / -0.0349 / -0.0141 (fp16, + EF, + EF over 2
# epochs), -0.0308 (csr over 2 epochs), 0 (disabled) in ACO and at most
# 6.03e-3 in the parameters, the reference's own two engines at most
# 2.9e-6 apart in ACO and 4.6e-7 in the parameters
P02_ACO, P02_PARAMS = 0.1, 1e-2


@pytest.mark.parametrize("case", list(CASES))
def test_lm_trainer_p02_within_the_tie_bounds(case):
    engine, wire = CASES[case]
    ref, want = _reference(wire)
    port, got = _port(engine, wire)
    _same_schedule(port, ref)
    _max_param_diff(port, ref, atol=P02_PARAMS, rtol=0.0)
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-4, m
    assert abs(got["aco"] - want["aco"]) < P02_ACO
    assert got["fleet"] == want["fleet"] and got["art"] == want["art"]


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_disabled_channel_books_the_references_bytes(engine):
    """``sparse_comm=False``: every upload and every broadcast a dense
    payload of N float32 values, booked as the reference books them,
    component by component; ACO exactly 1."""
    ref, want = _reference(OPTIONS["disabled"])
    port, got = _port(engine, OPTIONS["disabled"])
    assert got["aco"] == want["aco"] == 1.0
    theirs, ours = ref.comm.wire_breakdown(), port.comm.wire_breakdown()
    for key in ("values_bytes", "indices_bytes", "scales_bytes",
                "row_ptr_bytes", "dense_payload_bytes", "payload_bytes"):
        assert ours[key] == float(theirs[key]), key
    n = port._global_flat.numel()
    assert ours["dense_payload_bytes"] == 4 * n * port.comm.messages
    assert ours["values_bytes"] == ours["indices_bytes"] == 0.0


def test_p02_ties_amplify_ulps():
    """Why p0.2 is held apart. No row of the small LM is confident (the
    Eq. 5 mask is 0), so a client's update is Adam on the L1 term alone:
    every parameter moves by about lr a step, and the p0.2 threshold lies
    in that cluster. The reference's jitted Adam rounds the step a few
    ulps away from the port's IEEE sequence on some elements; each such
    element within a few ulps of the threshold may cross it."""
    from repro.core.model_adapter import make_adapter as j_make_adapter
    from repro.optimizer import adam_init as j_adam_init
    from repro_torch.core.model_adapter import make_adapter
    from repro_torch.optimizer import adam_init
    from repro_torch.weights import params_from_numpy
    jcfg, cfg = _cfgs()
    init = _init(jcfg)
    kw = dict(batch_size=16, threshold=0.95, l1=1e-5, epochs=1)
    ja = j_make_adapter(jcfg, use_kernel=False, **kw)
    pa = make_adapter(cfg, **kw)
    x = make_lm_dataset(8, **DATA)["clients"][0]["x"]
    jp = jax.tree.map(jax.numpy.asarray, init)
    tp = params_from_numpy(init, "cpu")
    a, _, _ = ja.client_epoch(jp, j_adam_init(jp), x, 5e-4,
                              jax.random.PRNGKey(1))
    b, _, _ = pa.client_epoch(tp, adam_init(tp), x, 5e-4)
    base = np.asarray(jcomm.flatten_tree(jp))
    want = np.asarray(jcomm.flatten_tree(a))
    got = sparse_comm.flatten_tree(b).numpy()
    # a few ulps of the operands (the base, or lr times the steps taken)
    ulp = np.spacing(np.maximum(np.abs(base), np.float32(5e-4 * 4)))
    assert np.all(np.abs(got - want) <= 4 * ulp)
    delta = np.abs(want - base)
    thr = float(sparse_comm.SparseComm("p0.2")._row_thresholds(
        torch.as_tensor(want - base)[None], fused="high")[0])
    near = np.abs(delta - thr) <= 8 * np.spacing(np.float32(thr))
    assert near.mean() > 0.05, near.mean()


def test_flat_order_is_jax_tree_leaves():
    """The port's flat vector of the reduced qwen2 tree holds the
    reference's ``jax.tree.leaves`` in order, name by name and value by
    value; names and sizes as the reference's ``leaf_sizes``."""
    jcfg, cfg = _cfgs()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    np.testing.assert_array_equal(
        sparse_comm.flatten_tree(tp).numpy(),
        np.asarray(jcomm.flatten_tree(jp)))
    assert param_layout.leaf_sizes(tp) == j_leaf_sizes(jp)
    back = sparse_comm.unflatten_like(sparse_comm.flatten_tree(tp), tp)
    for (_, a), (_, b) in zip(leaves_with_path(back), leaves_with_path(tp)):
        assert torch.equal(a, b)
    stack = torch.stack([sparse_comm.flatten_tree(tp)] * 2)
    again = sparse_comm.flatten_stacked(
        sparse_comm.unflatten_stacked(stack, tp))
    assert torch.equal(again, stack)


def test_list_indices_order_as_jax_does():
    """Lists keep their index order (10 after 2, which a string sort of
    joined paths would not give), dict keys sort at every level."""
    tree = {"b": [{"w": np.full(2, float(i))} for i in range(12)],
            "a_b": np.zeros(1), "a": {"z": np.ones(1), "y": np.ones(3)}}
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(tree)])
    got = sparse_comm.flatten_tree(tree_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    names = [n for n, _ in param_layout.leaf_sizes(
        tree_from_numpy(tree, "cpu"))]
    assert names == [n for n, _ in j_leaf_sizes(
        jax.tree.map(np.asarray, tree))]
    assert names.index("b/10/w") > names.index("b/2/w")


@pytest.mark.parametrize("override", [
    pytest.param({"base_store": "dense"}, id="dense-store"),
    pytest.param({"client_store": "paged", "error_feedback": True},
                 id="paged")])
def test_lm_outside_the_slice_raises(override):
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="queue 3b"):
        FedS3ATrainer(make_lm_dataset(8, **DATA),
                      FedS3AConfig(model=cfg, device="cpu", **override))


def test_param_count_is_the_references():
    jcfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tr = FedS3ATrainer(make_lm_dataset(8, **DATA),
                       FedS3AConfig(model=cfg, device="cpu", **RUN))
    assert tr.adapter.param_count() == jcfg.param_count()
    assert tr._global_flat.numel() == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(_init(jcfg)))


def test_lm_path_runs_without_jax_or_the_reference_package():
    code = textwrap.dedent("""
        import sys
        import torch
        from repro_torch.configs import get_config, load_all
        from repro_torch.core import FedS3AConfig, FedS3ATrainer, make_adapter
        from repro_torch.data import make_lm_dataset
        torch.set_num_threads(1)
        load_all()
        cfg = get_config("qwen2-1.5b").reduced(
            num_layers=1, d_model=64, d_ff=128, num_heads=2, num_kv_heads=1)
        for engine in ("sequential", "batched"):
            tr = FedS3ATrainer(make_lm_dataset(4, vocab_size=512,
                                               samples_per_client=16),
                               FedS3AConfig(model=cfg, rounds=1,
                                            batch_size=16, device="cpu",
                                            init_server_epochs=1,
                                            engine=engine))
            assert tr.adapter.kind == "lm"
            assert tr.train()["rounds"] == 1
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("isolated")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout
