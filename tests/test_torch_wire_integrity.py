"""Wire integrity and the quarantine of corrupt uploads in the port, against
the reference: ``validate_payload`` and ``malform_stats`` on both CSR wires
and random payload geometries (every nominal payload passes, every
malformed one raises ``WireIntegrityError`` in both packages, and the two
packages damage a payload the same way); a quarantine changes no trainer
state; quarantined uploads book no bytes; and on the dense wires, where
there is no payload to damage, the quarantine is the scheduler's
no-delivery path alone."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import WireIntegrityError as JWireIntegrityError  # noqa: E402
from repro.core.sparse_comm import SparseComm as JComm  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import REFERENCE_CHURN, WireIntegrityError  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.core.sparse_comm import (MALFORM_KINDS, Q_BLOCK,  # noqa: E402
                                          SparseComm)
from repro_torch.data import make_dataset  # noqa: E402

SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, SEED = 0.0015, 0
FAULTS = dict(round_deadline=700.0, quorum_floor=2)
CHURN = dataclasses.replace(REFERENCE_CHURN, corrupt_prob=0.2)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The models here are tiny: one intra-op thread a process. The suite
    runs in several worker processes at once, and more threads than cores
    in all only contend (several times the wall time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _payload(fmt, rows, cap, n, seed, q_dtype="int8"):
    """A nominal payload's delivery stats at an arbitrary geometry."""
    rng = np.random.default_rng(seed)
    stored = rng.integers(0, cap + 1, rows)
    if fmt == "csr":
        return {"nnz": stored, "total": n, "rows": rows,
                "values": rng.standard_normal((rows, cap)).astype(np.float32),
                "indices": rng.integers(0, n, (rows, cap)).astype(np.int32)}
    nblk = (n + Q_BLOCK - 1) // Q_BLOCK
    blocks = np.zeros((rows, nblk), np.int16)
    for r in range(rows):      # the stored count spread over the blocks
        np.add.at(blocks[r], rng.integers(0, nblk, stored[r]), 1)
    vdt = np.int8 if q_dtype == "int8" else np.float16
    return {"nnz": stored.astype(np.int32), "total": n, "rows": rows,
            "values": rng.integers(-127, 128, (rows, cap)).astype(vdt),
            "indices": rng.integers(0, Q_BLOCK, (rows, cap)).astype(np.int16),
            "blocks": blocks,
            "scales": rng.random(rows).astype(np.float32) + 0.01}


def _verdict(comm, stats):
    try:
        comm.validate_payload(stats)
        return "ok"
    except (WireIntegrityError, JWireIntegrityError) as exc:
        return str(exc)


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k


@pytest.mark.parametrize("fmt, q_dtype", [("csr", "int8"), ("csr_q", "int8"),
                                          ("csr_q", "fp16")])
def test_validation_and_malformations_match_reference(fmt, q_dtype):
    """Random geometries: the nominal payload passes both validators; each
    malformation kind gives the same damaged payload in both packages and
    both reject it with the same diagnosis; so do a few damages beyond the
    menu (a count past capacity, an inconsistent block table, a
    non-integer count vector, a short count vector)."""
    port = SparseComm("p0.2", wire_format=fmt, q_dtype=q_dtype)
    ref = JComm("p0.2", use_kernel=False, wire_format=fmt, q_dtype=q_dtype)
    for seed in range(12):
        rng = np.random.default_rng(100 + seed)
        rows, cap = int(rng.integers(1, 6)), int(rng.integers(1, 10))
        n = int(cap * 7 + rng.integers(1, 2000))
        stats = _payload(fmt, rows, cap, n, seed, q_dtype)
        assert port.validate_payload(stats) is stats
        assert _verdict(ref, stats) == "ok"
        for kind in MALFORM_KINDS:
            bad = port.malform_stats(stats, kind)
            _same(bad, ref.malform_stats(stats, kind))
            verdict = _verdict(port, bad)
            assert verdict != "ok" and verdict == _verdict(ref, bad), kind
        extra = [dict(stats, nnz=np.full(rows, cap + 1)),
                 dict(stats, nnz=np.asarray(stats["nnz"], np.float32)),
                 dict(stats, nnz=np.asarray(stats["nnz"])[:-1]),
                 dict(stats, total=0)]
        if fmt == "csr_q":
            extra.append(dict(stats, blocks=np.asarray(stats["blocks"]) + 1))
        for bad in extra:
            assert _verdict(port, bad) == _verdict(ref, bad) != "ok"
    with pytest.raises(ValueError, match="kind must be one of"):
        port.malform_stats(stats, "bitflip")


@pytest.mark.parametrize("fmt", ["csr", "csr_q"])
def test_real_payload_validates_and_stays_unbooked(fmt):
    """A payload the port's encode builds (torch tensors) passes; each
    malformed copy raises; validating books nothing and the nominal
    stats are not written."""
    comm = SparseComm("p0.2", wire_format=fmt)
    g = torch.Generator().manual_seed(0)
    base = torch.randn(3, 1300, generator=g)
    new = base + 0.1 * torch.randn(3, 1300, generator=g)
    payload, stored, _ = comm.csr_core(new, base)
    stats = comm.csr_stats(payload, stored, 1300)
    keep = {k: np.array(v) for k, v in stats.items()}
    before = comm.ledger_state()
    assert comm.validate_payload(stats) is stats
    for kind in MALFORM_KINDS:
        with pytest.raises(WireIntegrityError):
            comm.validate_payload(comm.malform_stats(stats, kind))
    assert comm.ledger_state() == before
    _same({k: np.asarray(v) for k, v in stats.items()}, keep)


def _port(**kw):
    cfg = dict(rounds=6, cnn=CNNConfig(**SMALL), seed=SEED, device="cpu",
               engine="batched", traffic=CHURN, **FAULTS)
    cfg.update(kw)
    return FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                         FedS3AConfig(**cfg))


@pytest.mark.parametrize("wire", ["csr", "csr_q"])
def test_quarantine_mutates_no_trainer_state(wire):
    """A boundary full of corrupt uploads leaves the global model, the ring,
    the EF residuals and the ledgers as they were; a malformed payload
    that got through validation would raise."""
    tr = _port(wire_format=wire, error_feedback=True)
    tr.train(2)
    flat, ring = tr._global_flat.clone(), tr.store.ring.clone()
    rows = tr.cstore.rows.clone()
    ledger, versions = tr.comm.ledger_state(), tr.base_versions
    tr._quarantine_uploads(SimpleNamespace(corrupted=[0, 3, 7, 9]))
    assert torch.equal(tr._global_flat, flat)
    assert torch.equal(tr.store.ring, ring)
    assert torch.equal(tr.cstore.rows, rows)
    assert tr.comm.ledger_state() == ledger
    np.testing.assert_array_equal(tr.base_versions, versions)
    tr.comm.validate_payload = lambda stats: stats
    with pytest.raises(RuntimeError, match="quarantine is broken"):
        tr._quarantine_uploads(SimpleNamespace(corrupted=[1]))


@pytest.mark.parametrize("wire", ["csr", "csr_q"])
def test_quarantined_uploads_book_zero_bytes(wire, monkeypatch):
    """Every round books one upload row a delivered participant and none
    for a quarantined (or lost) one; each quarantine ran the validator
    and was rejected."""
    tr = _port(wire_format=wire, rounds=8)
    rows, rejected = [], []
    book = tr.comm.account_batch_csr
    validate = tr.comm.validate_payload

    def account(stored, n, k):
        rows.append(k)
        return book(stored, n, k)

    def check(stats):
        try:
            return validate(stats)
        except WireIntegrityError:
            rejected.append(1)
            raise

    monkeypatch.setattr(tr.comm, "account_batch_csr", account)
    monkeypatch.setattr(tr.comm, "validate_payload", check)
    quarantined = 0
    for _ in range(8):
        rows.clear()
        log = tr.run_round()
        assert rows == [len(log.participants)]
        assert not set(log.corrupted) & set(log.participants)
        quarantined += len(log.corrupted)
    assert quarantined > 0, "profile produced no quarantined uploads"
    assert len(rejected) == quarantined


def test_dense_wire_books_no_corrupt_upload(monkeypatch):
    """On dense_masked + EF there are no payload arrays to damage: the
    corrupt uploads are dropped by the scheduler's no-delivery path, the
    validator never runs, and each round books one message a delivered
    participant. (The reference's sequential run books the same messages
    and dense bytes: tests/test_torch_faults.py.)"""
    tr = _port(wire_format="dense_masked", error_feedback=True, rounds=8)
    rows = []
    book = tr.comm.account_batch

    def account(nnz, n, k):
        rows.append(k)
        return book(nnz, n, k)

    def never(stats):
        raise AssertionError("validated a dense-wire upload")

    monkeypatch.setattr(tr.comm, "account_batch", account)
    monkeypatch.setattr(tr.comm, "validate_payload", never)
    corrupted = 0
    for _ in range(8):
        rows.clear()
        log = tr.run_round()
        assert rows == [len(log.participants)]
        assert not set(log.corrupted) & set(log.participants)
        corrupted += len(log.corrupted)
    assert corrupted > 0, "profile produced no corrupt uploads"
