"""Error feedback in the port on the CPU, against the JAX package: the comm
layer's EF encodes on the four channels (csr, csr_q, dense_masked, the
disabled channel) against ``SparseComm(use_kernel=False)``, whole trainers
on both engines with EF on the csr and csr_q wires against the reference's
SEQUENTIAL engine, the forced-restart reset of a residual on both engines,
and EF's recovery of the whole delta (``tests/test_error_feedback.py:17``).

Trainers at a reduced width with dropout 0, from the reference's own
initial weights, are held to the reference's cross-engine criteria
(``tests/test_engine_parity.py:125, :136``): exact schedules, parameters at
atol 1e-4 / rtol 1e-3, metrics within 1e-4, ACO within 2e-3. Their byte
ledgers' framing (messages, dense bytes, row_ptr, scales, block tables) is
exact; so are the stored elements on csr. On csr_q the stored elements
agree to 1e-3: the two packages' float32 training differs at ~1e-8, which
can carry a value across a rounding boundary of the int8 grid, move the
dequantized global model by one quantum, and so move an element across the
next chain transition's threshold."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.core import sparse_comm as jsc  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import sparse_comm as tsc  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

SMALL = dict(conv_filters=(8, 8), hidden=16, dropout=0.0)
CHANNELS = {"csr": dict(wire_format="csr"),
            "csr_q": dict(wire_format="csr_q"),
            "csr_q_fp16": dict(wire_format="csr_q", q_dtype="fp16"),
            "dense_masked": dict(wire_format="dense_masked"),
            "disabled": dict(enabled=False)}


def _trees(rng, count, scale=1e-2):
    return [{"a": rng.standard_normal((32, 16)).astype(np.float32) * scale,
             "b": rng.standard_normal(64).astype(np.float32) * scale}
            for _ in range(count)]


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(np.asarray(v)) for k, v in tree.items()}


def _equal_trees(t, j):
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


@pytest.mark.parametrize("channel", list(CHANNELS))
def test_ef_encodes_match_reference(channel):
    """Three one-message encodes with the residual carried, then one
    batched encode of three rows with residuals: decoded deltas, new
    residuals, counts and every ledger component equal the reference's."""
    ops.reset_launches()
    kw = CHANNELS[channel]
    tc = tsc.SparseComm("p0.3", **kw)
    jc = jsc.SparseComm("p0.3", use_kernel=False, **kw)
    rng = np.random.default_rng(len(channel))
    news = _trees(rng, 3)
    tbase = {k: torch.zeros(v.shape) for k, v in news[0].items()}
    tres = {k: torch.zeros(v.shape) for k, v in news[0].items()}
    jbase, jres = _j(tbase), _j(tres)
    for new in news:
        td, tstats, tres = tc.encode(_t(new), tbase, residual=tres)
        jd, jstats, jres = jc.encode(_j(new), jbase, residual=jres)
        _equal_trees(td, jd)
        _equal_trees(tres, jres)
        assert int(tstats["nnz"]) == int(jstats["nnz"])
        tbase, jbase = tc.apply(tbase, td), jc.apply(jbase, jd)
    flat = np.stack([np.asarray(jsc.flatten_tree(t)) for t in news])
    res = rng.standard_normal(flat.shape).astype(np.float32) * 3e-3
    base = flat[::-1].copy()
    tout = tc.encode_batch(torch.tensor(flat), torch.tensor(base),
                           torch.tensor(res))
    jout = jc.encode_batch(jnp.asarray(flat), jnp.asarray(base),
                           jnp.asarray(res))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(np.asarray(tout[1]["nnz"]),
                                  np.asarray(jout[1]["nnz"]))
    assert tc.wire_breakdown() == jc.wire_breakdown()
    assert (tc.aco, tc.messages, tc.dense_bytes) == \
        (jc.aco, jc.messages, jc.dense_bytes)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


@pytest.mark.parametrize("wire", ["csr", "csr_q"])
def test_ef_recovers_full_delta(wire):
    """Sending the same target again and again with EF converges to it,
    while plain sparsification loses the masked mass for good."""
    rng = np.random.default_rng(0)
    target = _t(_trees(rng, 1, scale=1.0)[0])
    zero = {k: torch.zeros_like(v) for k, v in target.items()}
    comm = tsc.SparseComm("p0.3", wire_format=wire)
    recon, residual = zero, zero
    for _ in range(12):
        delta, _, residual = comm.encode(target, recon, residual=residual)
        recon = comm.apply(recon, delta)
    plain = tsc.SparseComm("p0.3", wire_format=wire)
    once = plain.apply(zero, plain.encode(target, zero)[0])

    def err(tree):
        return max(float((tree[k] - target[k]).abs().max()) for k in target)

    assert err(recon) < err(once) * 0.25
    assert err(recon) < 0.05


# -- whole trainers --------------------------------------------------------
SCALE, ROUNDS, SEED = 0.0015, 2, 0


@functools.lru_cache(maxsize=None)
def _reference(wire):
    """The reference's sequential engine with EF on ``wire``, and its
    initial weights (its ``_init_models`` draws them from the second half
    of ``split(PRNGKey(seed))``)."""
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    init = {n: np.asarray(v) for n, v in jcnn.init_cnn(JCNN(**SMALL),
                                                       k).items()}
    ref = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                   JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                           engine="sequential", use_kernels=False,
                           wire_format=wire, error_feedback=True))
    return init, ref, ref.train()


FRAMING = ("messages", "dense_bytes", "scales_bytes", "block_table_bytes")


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("wire", ["csr", "csr_q"])
def test_ef_trainer_matches_reference_sequential_engine(engine, wire):
    init, ref, want = _reference(wire)
    port = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                         FedS3AConfig(rounds=ROUNDS, cnn=CNNConfig(**SMALL),
                                      seed=SEED, device="cpu", engine=engine,
                                      wire_format=wire, error_feedback=True),
                         init_params=init)
    assert port.engine == engine
    got = port.train()
    for a, b in zip(port.logs, ref.logs, strict=True):
        assert (a.round, a.participants, a.stalenesses, a.forced, a.time,
                a.art) == (b.round, b.participants, b.stalenesses, b.forced,
                           b.time, b.art)
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)
    jp = {n: np.asarray(v) for n, v in ref.global_params.items()}
    tp = params_to_numpy(port.global_params)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], atol=1e-4, rtol=1e-3,
                                   err_msg=n)
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-4, m
    assert abs(got["aco"] - want["aco"]) < 2e-3
    assert got["fleet"] == want["fleet"] and got["rounds"] == want["rounds"]
    assert got["art"] == want["art"]
    assert port.store.bytes() == ref.store.bytes()   # detach flags too
    # every client's residual row against the reference's residual tree
    for i in range(port.M):
        r = ref.clients[i].get("residual")
        want_row = np.zeros(port.cstore.n, np.float32) \
            if r is None else np.asarray(jsc.flatten_tree(r))
        np.testing.assert_allclose(port.cstore.residual_row(i), want_row,
                                   atol=1e-4, rtol=1e-3)
    # the ledgers: framing exact; a batch books one row_ptr for its K rows
    # where the sequential engine books one per message
    tw, jw = port.comm.wire_breakdown(), ref.comm.wire_breakdown()
    for f in FRAMING:
        assert getattr(port.comm, f) == getattr(ref.comm, f), f
    merged = 4 * sum(len(log.participants) - 1 for log in port.logs) \
        if engine == "batched" else 0
    assert tw["row_ptr_bytes"] == jw["row_ptr_bytes"] - merged
    if wire == "csr":
        assert (tw["values_bytes"], tw["indices_bytes"]) == \
            (jw["values_bytes"], jw["indices_bytes"])
    else:
        assert abs(tw["values_bytes"] - jw["values_bytes"]) <= \
            1e-3 * jw["values_bytes"]
        assert tw["indices_bytes"] - jw["indices_bytes"] == \
            2 * (tw["values_bytes"] - jw["values_bytes"])


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_forced_restart_zeroes_the_residual(engine):
    """tau = 0 forces stragglers every round: a forced client's residual
    row is zero after the round, including clients that had uploaded (and
    so carried a residual) before; participants keep theirs."""
    port = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                         FedS3AConfig(rounds=10, cnn=CNNConfig(**SMALL),
                                      seed=SEED, device="cpu", engine=engine,
                                      tau=0, C=0.8, error_feedback=True))
    participated, reset_checked = set(), 0
    for _ in range(10):
        log = port.run_round()
        for i in log.forced:
            assert not port.cstore.residual_row(i).any()
            reset_checked += i in participated
        for i in set(log.participants) - set(log.forced):
            assert port.cstore.residual_row(i).any()
        participated.update(log.participants)
        if reset_checked:
            break
    assert reset_checked > 0
