"""The fault layer in the port's trainer, against the reference, on the CPU:
the versioned base store's churn (detach, rejoin split, full-model resync,
eviction with detached clients, the broadcast ledger) under random
operation sequences; faulted runs of the port's engines (sequential,
batched, paged) on the csr, csr_q + EF and dense_masked + EF wires
against the reference's sequential engine, under ``REFERENCE_CHURN`` with
corruption, a round deadline and a quorum floor of 2; and residual
hygiene (lost, quarantined,
departed and rejoined clients' residuals read zero after the boundary).
The chunked body under faults is held in tests/test_torch_fleet_ckpt.py,
beside its resume test.

Bounds. The fault trace, ``client_version``, ``detached`` and the fleet
dict must be equal. The port's sequential engine is held to the
reference's cross-engine bounds (metrics < 1e-4, ACO < 2e-3,
tests/test_engine_parity.py:125,136). The port's stacked bodies are held
to a tolerance taken from the reference's own spread under faults: the
reference's batched engine against its sequential one, same config, seed
and 8 rounds, differs by 0 in every metric and by 2.03e-4 (csr), 1.1e-6
(csr_q + EF), 6.0e-6 (dense_masked + EF) and 0 (chunked csr_q + EF) in
ACO; after the chaos suite's 50 rounds by 3.33e-3 in its metrics and
3.7e-4 in ACO (tests/reference_spread.py). At these 8 rounds the spread
is under the cross-engine bounds, so the bounds stand for the stacked
bodies too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.core import REFERENCE_CHURN as J_CHURN  # noqa: E402
from repro.core import VersionedBaseStore as JStore  # noqa: E402
from repro.core.sparse_comm import SparseComm as JComm  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import REFERENCE_CHURN, VersionedBaseStore  # noqa: E402
from repro_torch.core import fleet_ckpt  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.core.sparse_comm import SparseComm  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402

SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, SEED, ROUNDS = 0.0015, 0, 8
FAULTS = dict(round_deadline=700.0, quorum_floor=2)
CHURN = dataclasses.replace(REFERENCE_CHURN, corrupt_prob=0.05)
J_CHURN_C = dataclasses.replace(J_CHURN, corrupt_prob=0.05)
WIRES = {"csr": {"wire_format": "csr"},
         "csrq-ef": {"wire_format": "csr_q", "error_feedback": True},
         "dense-ef": {"wire_format": "dense_masked", "error_feedback": True}}
# the reference's cross-engine bounds; the stacked bodies' spread-derived
# tolerance (module docstring) is no wider
METRIC_TOL, ACO_TOL = 1e-4, 2e-3
# dense_masked + EF: the port's ACO drifts from the reference's through
# survivor counts at threshold ties, faults or not. A message's |delta|
# holds whole runs of equal magnitudes (1,956-3,127 of 10,385 elements
# exactly at the threshold of a round's first upload), so a rounding-level
# difference in the state flips whole runs of survivors: the first flip
# is one element in round 1, and ACO drifts 9.56e-3 after these 8 faulted
# rounds, 9.34e-3 after 12 fault-free ones (the reference's own engines:
# 6.0e-6 and 3.2e-4; tests/reference_spread.py --messages). So on this
# wire ACO is held at 1.5e-2, everything the trace fixes exactly
# (ROADMAP.md section 3).
DENSE_EF_ACO_TOL = 1.5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The models here are tiny: one intra-op thread a process. The suite
    runs in several worker processes at once, and more threads than cores
    in all only contend (several times the wall time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the base store's churn ------------------------------------------------
def _check_stores(port, ref, pcomm, rcomm):
    np.testing.assert_array_equal(port.client_version, ref.client_version)
    np.testing.assert_array_equal(port.detached, ref.detached)
    np.testing.assert_array_equal(port.slot_version, ref.slot_version)
    assert port.version == ref.version
    np.testing.assert_array_equal(port.ring.numpy(), np.asarray(ref.ring))
    assert port.dist_payload_bytes() == ref.dist_payload_bytes()
    assert port.bytes() == ref.bytes()
    assert (pcomm.payload_bytes, pcomm.dense_bytes, pcomm.messages) == \
        (rcomm.payload_bytes, rcomm.dense_bytes, rcomm.messages)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tau", [0, 2])
def test_base_store_churn_matches_reference(tau, seed):
    """Random boundaries: departures detach, rejoiners split into chain
    suffix and resync, the broadcast is booked, an eviction that would drop
    an attached client's version raises in both (the clients are then
    force-rebased, as the scheduler would), and a store restored from its
    checkpoint state mid-sequence goes on as the live one would."""
    rng = np.random.default_rng(seed)
    M, n = 12, 64
    flat = rng.standard_normal(n).astype(np.float32)
    port = VersionedBaseStore(torch.from_numpy(flat), M, tau)
    ref = JStore(jnp.asarray(flat), M, tau)
    pcomm = SparseComm("p0.2", wire_format="csr")
    rcomm = JComm("p0.2", use_kernel=False, wire_format="csr")
    evictions = resyncs = 0
    for step in range(40):
        if step == 20:          # through the checkpoint encoding
            saved = fleet_ckpt.unpack(fleet_ckpt.pack(
                {"store": port.state_dict(defer=True),
                 "comm": pcomm.ledger_state(defer=True)}))
            port = VersionedBaseStore(torch.from_numpy(flat), M, tau)
            port.load_state_dict(saved["store"])
            pcomm = SparseComm("p0.2", wire_format="csr")
            pcomm.load_ledger_state(saved["comm"])
        new = port.version + 1
        away = rng.random(M) < 0.2
        port.detach(np.nonzero(away)[0])
        ref.detach(np.nonzero(away)[0])
        rejoin = [int(i) for i in np.nonzero(port.detached)[0]
                  if rng.random() < 0.4]
        split = port.split_rejoined(rejoin, new)
        assert split == ref.split_rejoined(rejoin, new)
        recon = rng.standard_normal(n).astype(np.float32)
        stored = int(rng.integers(0, n))
        for attempt in range(2):
            try:
                port.advance(torch.from_numpy(recon),
                             {"stored": torch.tensor(stored,
                                                     dtype=torch.int32)},
                             new)
                raised = None
            except RuntimeError as exc:
                raised = str(exc)
            try:
                ref.advance(jnp.asarray(recon), {"stored": jnp.int32(stored)},
                            new)
                assert raised is None
                break
            except RuntimeError as exc:
                assert raised == str(exc)
                evictions += 1
                evicted = port.slot_version[port.slot(new)]
                stale = [int(i) for i in np.nonzero(
                    port.client_version == evicted)[0]]
                port.detach(stale)
                ref.detach(stale)
        # targets: clients the retained chain can still reach
        reach = (port.client_version < port.version) & \
            (port.client_version >= port.version - tau - 1)
        behind = [int(i) for i in np.nonzero(reach)[0] if rng.random() < 0.5]
        targets = sorted(set(behind) | set(split[0]))
        port.account_distribution(pcomm, targets)
        ref.account_distribution(rcomm, targets)
        port.resync(pcomm, split[1])
        ref.resync(rcomm, split[1])
        resyncs += len(split[1])
        _check_stores(port, ref, pcomm, rcomm)
    assert resyncs > 0 and (tau > 0 or evictions > 0)


# -- faulted runs against the reference's sequential engine ----------------
_REF = {}


def _init():
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    return {n: np.asarray(v) for n, v in j_init_cnn(JCNN(**SMALL), k).items()}


def _ref(wire):
    """The reference's sequential run of ``wire`` under faults (cached for
    the module: the port's engines are all held against it)."""
    if wire not in _REF:
        tr = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                      JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                              engine="sequential", traffic=J_CHURN_C,
                              **FAULTS, **WIRES[wire]))
        _REF[wire] = (tr, tr.train())
    return _REF[wire]


def _port(engine, wire, **kw):
    cfg = dict(rounds=ROUNDS, cnn=CNNConfig(**SMALL), seed=SEED,
               device="cpu", engine=engine, traffic=CHURN, **FAULTS,
               **WIRES[wire])
    cfg.update(kw)
    tr = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                       FedS3AConfig(**cfg), init_params=_init())
    return tr, tr.train()


def trace(tr):
    """Everything a fault trace fixes, round by round."""
    return [(l.participants, dict(l.stalenesses), l.forced, l.lost,
             l.corrupted, l.departed, l.rejoined, l.resynced, l.quorum,
             l.target_k, l.degraded, l.deadline_hit, l.crashes, l.time,
             l.art) for l in tr.logs]


def _hold(port, got, ref, want, aco_tol=ACO_TOL):
    assert trace(port) == trace(ref)
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)
    np.testing.assert_array_equal(port.store.detached, ref.store.detached)
    assert got["fleet"] == want["fleet"]
    assert got["art"] == want["art"] and got["rounds"] == want["rounds"]
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < METRIC_TOL, m
    assert abs(got["aco"] - want["aco"]) < aco_tol
    assert port.comm.messages == ref.comm.messages
    assert port.comm.dense_bytes == ref.comm.dense_bytes


@pytest.mark.parametrize("engine, wire, store", [
    ("sequential", "csr", "resident"), ("batched", "csr", "resident"),
    ("sequential", "csrq-ef", "resident"), ("batched", "csrq-ef", "resident"),
    ("batched", "csrq-ef", "paged"), ("sequential", "csrq-ef", "paged"),
    ("batched", "dense-ef", "resident")])
def test_faulted_run_matches_reference(engine, wire, store):
    """K from the quorum floor to 6 (degraded rounds, crashes, losses), and
    every event class of the trace fires: the port follows the reference
    event for event and within the bounds."""
    ref, want = _ref(wire)
    port, got = _port(engine, wire, client_store=store)
    assert port.engine == engine
    fleet = want["fleet"]
    assert fleet["crashes"] and fleet["lost_uploads"] and \
        fleet["quarantined"] and fleet["departures"] and \
        fleet["rejoins"] and fleet["resyncs"] and fleet["degraded_rounds"]
    assert len({l.quorum for l in port.logs}) > 1
    _hold(port, got, ref, want,
          DENSE_EF_ACO_TOL if wire == "dense-ef" else ACO_TOL)


@pytest.mark.parametrize("engine, store", [("batched", "resident"),
                                           ("batched", "paged"),
                                           ("sequential", "resident")])
def test_residual_hygiene_under_faults(engine, store):
    """After every faulted boundary the residuals of forced, lost,
    quarantined, departed and rejoined clients read zero, on either
    client store; the others keep theirs."""
    tr = FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                       FedS3AConfig(rounds=ROUNDS, cnn=CNNConfig(**SMALL),
                                    seed=SEED, device="cpu", engine=engine,
                                    client_store=store, traffic=CHURN,
                                    **FAULTS, **WIRES["csrq-ef"]))
    retired_any = kept_any = 0
    for _ in range(ROUNDS):
        log = tr.run_round()
        retired = set(log.forced) | set(log.lost) | set(log.corrupted) | \
            set(log.departed) | set(log.rejoined)
        retired_any += len(retired)
        for i in range(tr.M):
            row = tr.cstore.residual_row(i)
            if i in retired:
                assert not row.any(), i
            elif i in log.participants:
                kept_any += bool(row.any())
    assert retired_any > 0 and kept_any > 0
