"""The port's dense base store (``base_store="dense"``, the paper's own
per-client difference distribution) on the CPU against the JAX package,
at a reduced width (conv 8/8, hidden 16) with dropout 0 (the two packages
draw different random bits).

* ``DenseBaseStore`` (rows, versions, bytes) and ``distribute_core``, the
  batched engine's (T, N) distribution encode, against the reference's
  ``_distribute_encode_body`` on the same stacks, on every wire;
* whole trainers, both engines x {csr, csr_q + EF, dense_masked + EF,
  sparse_comm off}, 3 rounds at tau = 1, C = 0.4 (round 2 forces two
  stragglers, so T > K and the versions spread), against the reference's
  SEQUENTIAL dense engine (``use_kernels=False``): schedules, base
  versions and ``base_store_bytes()`` exact, metrics within 1e-4 and ACO
  within 2e-3 (the reference's cross-engine criteria,
  tests/test_engine_parity.py:125,136);
* with sparse_comm off, dense == versioned bit for bit on both engines
  (the reference's own pin);
* ``epochs=2`` on both stores and both engines against the reference;
* the reference's refusals, and the fact that lets the port keep only the
  base row: in the reference's dense sequential engine every client starts
  every round with its params equal to its base and a zeroed Adam state."""
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
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import DenseBaseStore, REFERENCE_CHURN  # noqa: E402
from repro_torch.core import base_store  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.core.sparse_comm import SparseComm  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.weights import params_to_numpy  # noqa: E402

SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, SEED, ROUNDS = 0.0015, 0, 3
SCHEDULE = dict(tau=1, C=0.4)
WIRES = {"csr": {"wire_format": "csr"},
         "csrq-ef": {"wire_format": "csr_q", "error_feedback": True},
         "dense-ef": {"wire_format": "dense_masked", "error_feedback": True},
         "off": {"sparse_comm": False}}
METRIC_TOL, ACO_TOL = 1e-4, 2e-3
# dense_masked + EF on the batched engine: threshold ties (whole runs of
# equal |delta| at a message's threshold; tests/test_torch_faults.py's
# DENSE_EF_ACO_TOL, ROADMAP.md section 3) move its survivor counts. On this
# schedule the reference's own batched engine is 2.43e-3 from its
# sequential one in ACO (metrics equal), past the cross-engine 2e-3, and
# the port's batched engine 4.10e-3. Held, as under faults, at 1.5e-2.
DENSE_EF_ACO_TOL = 1.5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny models: one intra-op thread a process (the suite runs in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init():
    """The reference's initial weights (its ``_init_models`` draws them
    from the second half of ``split(PRNGKey(seed))``)."""
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    return {n: np.asarray(v) for n, v in j_init_cnn(JCNN(**SMALL), k).items()}


@functools.lru_cache(maxsize=None)
def _ref(wire, store="dense", epochs=1):
    tr = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                  JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                          engine="sequential", use_kernels=False,
                          base_store=store, epochs=epochs, **SCHEDULE,
                          **WIRES[wire]))
    return tr, tr.train()


def _port(engine, wire, store="dense", epochs=1):
    tr = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                       FedS3AConfig(rounds=ROUNDS, cnn=CNNConfig(**SMALL),
                                    seed=SEED, device="cpu", engine=engine,
                                    base_store=store, epochs=epochs,
                                    **SCHEDULE, **WIRES[wire]),
                       init_params=_init())
    assert tr.engine == engine and tr.dense_store == (store == "dense")
    return tr, tr.train()


def _hold(port, got, ref, want, aco_tol=ACO_TOL):
    for a, b in zip(port.logs, ref.logs, strict=True):
        assert (a.round, a.participants, a.stalenesses, a.forced, a.time,
                a.art) == (b.round, b.participants, b.stalenesses, b.forced,
                           b.time, b.art)
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)
    assert port.base_store_bytes() == ref.base_store_bytes()
    assert port.comm.messages == ref.comm.messages
    assert port.comm.dense_bytes == ref.comm.dense_bytes
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < METRIC_TOL, m
    assert abs(got["aco"] - want["aco"]) < aco_tol
    assert got["art"] == want["art"] and got["rounds"] == want["rounds"]
    jp = {n: np.asarray(v) for n, v in ref.global_params.items()}
    tp = params_to_numpy(port.global_params)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], atol=1e-4, rtol=1e-3,
                                   err_msg=n)


# -- the store and the (T, N) encode ---------------------------------------
def test_dense_store_rows_versions_and_bytes():
    g = torch.arange(12, dtype=torch.float32)
    st = DenseBaseStore(g, 5)
    assert st.bytes() == 5 * 12 * 4 + 5 * 8
    np.testing.assert_array_equal(st.gather([4, 0]).numpy(),
                                  np.stack([g.numpy()] * 2))
    new = torch.stack([g + 1, g + 2])
    st.write([3, 1], new, 1)
    np.testing.assert_array_equal(st.client_version, [0, 1, 0, 1, 0])
    np.testing.assert_array_equal(st.gather([1, 3, 2]).numpy(),
                                  np.stack([g + 2, g + 1, g]).astype(
                                      np.float32))
    new += 10                     # the store keeps its own copy
    assert float(st.gather([3])[0, 0]) == 1.0
    assert base_store.DenseBaseStore is DenseBaseStore


@pytest.mark.parametrize("wire", ["csr", "csr_q-int8", "csr_q-fp16",
                                  "dense_masked", "off"])
def test_distribute_core_matches_reference(wire):
    """The new global model against seven targets' base rows, three of
    them at one version (equal rows), through the reference's jitted
    ``_distribute_encode_body``: counts and new rows bit for bit, and on
    the CSR wires the payload too. csr_q int8 rows: XLA contracts ``base +
    q * scale`` into one FMA where the port rounds the product first, so
    there a row element may differ by that rounding, at most a float32
    epsilon of the decoded value and of the row, and is held bit for bit
    against the reference's payload decoded the port's way."""
    fmt, _, q = wire.partition("-")
    kw = {"sparse_comm": False} if fmt == "off" else \
        {"wire_format": fmt, "q_dtype": q or "int8"}
    ref = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                   JConfig(rounds=1, cnn=JCNN(**SMALL), seed=SEED,
                           use_kernels=False, base_store="dense",
                           engine="batched", init_server_epochs=0, **kw))
    n = int(ref._global_flat.shape[0])
    rng = np.random.default_rng(3)
    g = rng.standard_normal(n).astype(np.float32) * 0.1
    bases = g + rng.standard_normal((7, n)).astype(np.float32) * 1e-3
    bases[4:] = bases[4]
    want_rows, want_counts = jax.jit(ref._distribute_encode_body())(
        jnp.asarray(g), jnp.asarray(bases))
    comm = SparseComm("p0.2", enabled=fmt != "off",
                      wire_format="csr" if fmt == "off" else fmt,
                      q_dtype=q or "int8")
    rows, counts = comm.distribute_core(torch.from_numpy(g),
                                        torch.from_numpy(bases))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    if fmt in ("csr", "csr_q"):
        payload, stored, _ = jax.jit(ref.comm.csr_core(False))(
            jnp.asarray(np.broadcast_to(g, bases.shape)), jnp.asarray(bases))
        got, _, decoded = comm.csr_core(
            torch.from_numpy(g).expand(7, n).contiguous(),
            torch.from_numpy(bases))
        for a, b in zip(got, payload, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(rows.numpy(), bases + decoded.numpy())
    if wire == "csr_q-int8":
        eps = np.finfo(np.float32).eps
        gap = np.abs(rows.numpy() - np.asarray(want_rows))
        assert (gap <= eps * (np.abs(decoded.numpy())
                              + np.abs(rows.numpy()))).all()
        assert gap.any()          # the FMA is there to be seen
    else:
        np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    if fmt == "off":
        np.testing.assert_array_equal(rows.numpy(), np.stack([g] * 7))
    else:
        assert int(counts.max()) < n


# -- whole trainers ---------------------------------------------------------
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_dense_trainer_matches_reference(engine, wire):
    ref, want = _ref(wire)
    port, got = _port(engine, wire)
    assert [len(l.forced) for l in port.logs] == [0, 2, 0]
    assert len(set(port.base_versions.tolist())) > 1
    _hold(port, got, ref, want,
          DENSE_EF_ACO_TOL if (engine, wire) == ("batched", "dense-ef")
          else ACO_TOL)
    if wire == "off":
        assert got["aco"] == want["aco"] == 1.0


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_dense_equals_versioned_without_sparsification(engine):
    """A disabled channel copies the model exactly into every target's row,
    which is the versioned store's reconstruction bit for bit: the same
    parameters, metrics, ACO and versions."""
    dense, dout = _port(engine, "off")
    vers, vout = _port(engine, "off", store="versioned")
    assert torch.equal(dense._global_flat, vers._global_flat)
    assert dout["metrics"] == vout["metrics"] and dout["aco"] == vout["aco"]
    np.testing.assert_array_equal(dense.base_versions, vers.base_versions)
    assert [l.participants for l in dense.logs] == \
        [l.participants for l in vers.logs]
    assert dense.base_store_bytes() == 10 * dense._global_flat.numel() * 4 \
        + 10 * 8 > vers.base_store_bytes()


@pytest.mark.parametrize("store", ["dense", "versioned"])
@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_two_epochs_match_reference(engine, store):
    """``epochs=2``: each participant runs two local epochs from its base
    before it uploads (dropout 0: the reference folds the epoch into its
    dropout key, the port draws all epochs' masks from one seed)."""
    ref, want = _ref("csr", store, epochs=2)
    port, got = _port(engine, "csr", store, epochs=2)
    _hold(port, got, ref, want)
    one, _ = _ref("csr", store)
    assert not np.array_equal(np.asarray(jsc.flatten_tree(one.global_params)),
                              np.asarray(jsc.flatten_tree(ref.global_params)))


@pytest.mark.parametrize("override, match", [
    pytest.param({"client_store": "paged"}, "client_store='paged'",
                 id="paged"),
    pytest.param({"traffic": REFERENCE_CHURN}, "traffic=", id="traffic"),
    pytest.param({"checkpoint_dir": "ckpt"}, "checkpoint_dir", id="ckpt"),
    pytest.param({"chunk_size": 64}, "chunked layouts require base_store",
                 id="chunked"),
    pytest.param({"base_store": "ring"}, "base_store must be one of",
                 id="unknown")])
def test_dense_store_refusals(override, match):
    cfg = dict(cnn=CNNConfig(**SMALL), device="cpu", base_store="dense")
    cfg.update(override)
    with pytest.raises(ValueError, match=match):
        FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                      FedS3AConfig(**cfg))


def test_reference_clients_start_every_round_at_their_base():
    """The reference's dense sequential engine keeps per-client params and
    Adam state beside the base; at every round start they equal the base
    and the zeroed state, so the port keeps the base row alone."""
    tr = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                  JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                          engine="sequential", use_kernels=False,
                          base_store="dense", **SCHEDULE))
    zero = jsc.flatten_tree(tr._zero_opt["m"])
    for _ in range(ROUNDS + 1):
        for c in tr.clients:
            np.testing.assert_array_equal(
                np.asarray(jsc.flatten_tree(c["params"])),
                np.asarray(jsc.flatten_tree(c["base_params"])))
            for k in ("m", "v"):
                np.testing.assert_array_equal(
                    np.asarray(jsc.flatten_tree(c["opt"][k])),
                    np.zeros_like(np.asarray(zero)))
            assert int(c["opt"]["t"]) == 0
        tr.run_round()
    assert len({c["base_version"] for c in tr.clients}) > 1
