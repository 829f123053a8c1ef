"""Faults on the FL language-model path, flat and chunked, and the port's
twin of ``examples/fl_large_model.py``, on the CPU (fleet checkpoints of
the same runs: tests/test_torch_lm_ckpt.py).

Model and data as tests/test_torch_lm_chunked.py: ``lm-small`` at V = 512,
float32, ``make_lm_dataset(8, ...)``, batch 16, lr 5e-4, one server
warm-up epoch, the reference's own initial LM parameters. Faults:
``REFERENCE_CHURN`` with 10% corrupt uploads, a 700 s deadline, a quorum
floor of 2, tau 2, seed 1, 6 rounds, chosen on the reference so that every
fault class fires (crashes, lost, quarantined, departures, rejoins,
resyncs, degraded rounds). An absolute threshold (every nonzero element
sent).

Bounds. Against the reference's sequential engine (``use_kernels=False``):
the fault trace (participants, stalenesses, forced, lost, quarantined,
departed, rejoined, resynced, quorum, target K, degraded, deadline hits,
crashes, times), versions, detached mask, fleet dict and messages exact;
parameters atol 1e-4 / rtol 1e-3 (over 2 epochs with ``EPOCHS_OUTSIDE``
exceptions), metrics 1e-4, ACO 2e-3 (the reference's cross-engine bounds,
tests/test_engine_parity.py:125, :136). Cells: flat csr, chunked csr +
EF, flat dense_masked over 2 epochs, the flat disabled channel and
chunked fp16 csr_q + EF over 2 epochs."""
import dataclasses
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.bench_fleet import LM_PRESETS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import load_all as jload_all  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.core import REFERENCE_CHURN as J_CHURN  # noqa: E402
from repro.data.synthetic_lm import make_lm_dataset as j_make_lm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, load_all  # noqa: E402
from repro_torch.core import REFERENCE_CHURN, TrafficModel  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_lm_dataset  # noqa: E402
from repro_torch.launch import fl_large_model  # noqa: E402
from repro_torch.tree import leaves_with_path, path_name  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LM_SMALL = dict(LM_PRESETS["lm-small"], dtype="float32")
DATA = dict(vocab_size=512, seq_len=16, num_classes=8)
SEED, ROUNDS = 1, 6
RUN = dict(rounds=ROUNDS, batch_size=16, lr=5e-4, seed=SEED, tau=2,
           init_server_epochs=1, sparse_threshold=1e-6,
           round_deadline=700.0, quorum_floor=2)
CHURN = dataclasses.replace(REFERENCE_CHURN, corrupt_prob=0.10)
J_CHURN_C = dataclasses.replace(J_CHURN, corrupt_prob=0.10)
CHUNK = 60_000
CELLS = {"flat-csr": {},
         "chunked-csr-ef": dict(chunk_size=CHUNK, error_feedback=True),
         "flat-dense-masked-epochs-2": dict(wire_format="dense_masked",
                                            epochs=2),
         "flat-disabled": dict(sparse_comm=False),
         "chunked-fp16-ef-epochs-2": dict(chunk_size=CHUNK,
                                          wire_format="csr_q",
                                          q_dtype="fp16",
                                          error_feedback=True, epochs=2)}
# Over 2 epochs a few parameters pass atol 1e-4 / rtol 1e-3, each within
# two Adam steps (2 lr): Adam + L1 walk entries across zero, where an ulp of
# the gradient picks a step's sign (tests/test_torch_lm_trainer.py's
# EPOCHS_OUTSIDE), and 6 faulted rounds give more such entries. Measured
# (one intra-op thread; on either engine): 3 of 213,248 outside
# (dense_masked, max 2.14e-4) and 17 (chunked fp16 + EF, max 2.32e-4); the
# port against itself with lr moved 2 ulps: 2 and 73 outside, max 1.66e-4
# and 2.40e-4. Metrics equal, ACO within 1e-6
EPOCHS_OUTSIDE = 20
FLEET = ("crashes", "lost_uploads", "quarantined", "departures", "rejoins",
         "resyncs", "degraded_rounds")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread a process: the suite runs in several worker
    processes at once, and more threads than cores only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    jload_all()
    load_all()
    return (jget_config("qwen2-1.5b").reduced(**LM_SMALL),
            get_config("qwen2-1.5b").reduced(**LM_SMALL))


def _init(jcfg):
    """The reference trainer's initial LM parameters (the second half of
    split(PRNGKey(seed))), leaf by leaf as numpy."""
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    return jax.tree.map(np.asarray, jlm.init_params(jcfg, k))


_REFERENCE = {}


def _reference(cell):
    if cell not in _REFERENCE:
        jcfg, _ = _cfgs()
        tr = JTrainer(j_make_lm(8, **DATA),
                      JConfig(model=jcfg, engine="sequential",
                              use_kernels=False, traffic=J_CHURN_C,
                              **RUN, **CELLS[cell]))
        _REFERENCE[cell] = (tr, tr.train())
    return _REFERENCE[cell]


def _trainer(cell, engine, **kw):
    jcfg, cfg = _cfgs()
    return FedS3ATrainer(
        make_lm_dataset(8, **DATA),
        FedS3AConfig(model=cfg, device="cpu", engine=engine, traffic=CHURN,
                     **RUN, **CELLS[cell], **kw),
        init_params=_init(jcfg))


def _port(cell, engine):
    tr = _trainer(cell, engine)
    return tr, tr.train()


def trace(tr):
    """Everything a fault trace fixes, round by round."""
    return [(l.participants, dict(l.stalenesses), l.forced, l.lost,
             l.corrupted, l.departed, l.rejoined, l.resynced, l.quorum,
             l.target_k, l.degraded, l.deadline_hit, l.crashes, l.time,
             l.art) for l in tr.logs]


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_faulted_lm_matches_reference(cell, engine):
    """Every fault class fires within the 6 rounds, K moves with the
    quorum, and the port follows the reference event for event."""
    ref, want = _reference(cell)
    port, got = _port(cell, engine)
    assert port.chunked == ("chunk_size" in CELLS[cell])
    assert all(want["fleet"][k] for k in FLEET), want["fleet"]
    assert len({l.quorum for l in ref.logs}) > 1
    assert trace(port) == trace(ref)
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)
    np.testing.assert_array_equal(port.store.detached, ref.store.detached)
    assert got["fleet"] == want["fleet"]
    assert got["art"] == want["art"] and got["rounds"] == want["rounds"]
    assert port.comm.messages == ref.comm.messages
    assert port.comm.dense_bytes == ref.comm.dense_bytes
    jp = jax.tree_util.tree_flatten_with_path(ref.global_params)[0]
    tp = leaves_with_path(params_to_numpy(port.global_params))
    if "epochs" not in CELLS[cell]:
        for (_, jv), (path, v) in zip(jp, tp, strict=True):
            np.testing.assert_allclose(v, np.asarray(jv), atol=1e-4,
                                       rtol=1e-3, err_msg=path_name(path))
    else:
        past = []
        for (_, jv), (path, v) in zip(jp, tp, strict=True):
            jv = np.asarray(jv)
            assert v.shape == jv.shape, path_name(path)
            gap = np.abs(v - jv)
            # a NaN compares False: counted outside
            past += [(path_name(path), float(d))
                     for d in gap[~(gap <= 1e-4 + 1e-3 * np.abs(jv))]]
        assert len(past) <= EPOCHS_OUTSIDE and \
            all(d <= 2 * RUN["lr"] for _, d in past), past[:8]
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-4, m
    assert abs(got["aco"] - want["aco"]) < 2e-3


def _launch_config(model, device="cpu"):
    """``examples/fl_large_model.py``'s trainer config, written out."""
    return FedS3AConfig(
        model=model, chunk_size=-(-model.param_count() // 6), rounds=1,
        C=0.5, tau=2, batch_size=16, lr=5e-4, error_feedback=True,
        traffic=TrafficModel(crash_rate=0.05, upload_loss=0.05),
        round_deadline=2000.0, quorum_floor=1, seed=0, device=device)


def test_fl_large_model_equals_an_in_process_trainer(capsys):
    """``main`` at 1 round and 4 clients gives the trainer that the
    example's config gives in process, bit for bit, and prints the
    example's lines."""
    tr = fl_large_model.main(["--rounds", "1", "--clients", "4",
                              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    load_all()
    model = get_config("qwen2-1.5b").reduced()
    twin = FedS3ATrainer(make_lm_dataset(4, vocab_size=model.vocab_size,
                                         seq_len=16, num_classes=8,
                                         samples_per_client=48, seed=0),
                         _launch_config(model))
    twin.run_round()
    assert tr.cfg == twin.cfg and tr.layout.bounds == twin.layout.bounds
    assert torch.equal(tr._global_flat, twin._global_flat)
    assert trace(tr) == trace(twin)
    assert tr.comm.aco == twin.comm.aco
    assert lines[0] == (f"arch=qwen2-1.5b reduced: 2L d=256 vocab=512 -> "
                        f"{model.param_count():,} params, M=4 clients")
    assert re.fullmatch(r"layout: \d+ chunks \(max [\d,]+, min [\d,]+\) "
                        r"over n=[\d,]+; engine=\w+", lines[3])
    assert re.fullmatch(r"  round  0  quorum=\d+/\d+  crashes=\d+  lost=\d+"
                        r"  (degraded )?acc=\d\.\d{4}", lines[5])
    assert lines[-2] == f"final: acc={twin.evaluate()['accuracy']:.4f}  " \
                        f"ACO={twin.comm.aco:.3f}"
    assert lines[-1].startswith("wire layout: {'n': ")


def test_fl_large_model_runs_without_jax_or_the_reference_package():
    """The module run as a script, with the environment knobs, imports
    neither ``jax`` nor ``repro``; without a card ``--device cuda`` (the
    default) raises."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch import fl_large_model
        tr = fl_large_model.main(["--device", "cpu"])
        assert len(tr.logs) == 1 and tr.M == 2
        assert tr.layout.num_chunks >= 3
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        if not torch.cuda.is_available():
            try:
                fl_large_model.main([])
            except RuntimeError as exc:
                assert "--device cpu" in str(exc)
            else:
                raise AssertionError("--device cuda ran without a card")
        print("isolated")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), EXAMPLES_ROUNDS="1",
               EXAMPLES_LM_CLIENTS="2", EXAMPLES_LM_CHUNKS="3")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout
    assert "final: acc=" in res.stdout
