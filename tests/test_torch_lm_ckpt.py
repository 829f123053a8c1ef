"""Fleet checkpoints on the FL language-model path, on the CPU: a faulted
run saved mid-way (``save_checkpoint(wait=True)`` and ``wait=False``),
restored onto a fresh trainer built from the same config and finished,
equals the uninterrupted run bit for bit. Five trainers: the flat
sequential engine, whose server Adam state is the LM's nested tree
(dicts and lists), the flat batched engine, the chunked batched engine
with EF pages, the flat sequential engine on dense_masked + EF (dense EF
rows) and the flat batched engine on fp16 csr_q + EF over 2 epochs.

Model, data and faults as tests/test_torch_lm_faults.py (``lm-small`` at
V = 512, float32, ``make_lm_dataset(8, ...)``, ``REFERENCE_CHURN`` with
10% corrupt uploads, a 700 s deadline, a quorum floor of 2, tau 2, seed 1,
6 rounds, where every fault class fires)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, load_all  # noqa: E402
from repro_torch.core import REFERENCE_CHURN  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_lm_dataset  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

LM_SMALL = dict(num_layers=1, d_model=128, d_ff=256, num_heads=2,
                num_kv_heads=1, dtype="float32")
DATA = dict(vocab_size=512, seq_len=16, num_classes=8)
SEED, ROUNDS = 1, 6
RUN = dict(rounds=ROUNDS, batch_size=16, lr=5e-4, seed=SEED, tau=2,
           init_server_epochs=1, sparse_threshold=1e-6,
           round_deadline=700.0, quorum_floor=2,
           traffic=dataclasses.replace(REFERENCE_CHURN, corrupt_prob=0.10))
CELLS = {"flat-csr": {},
         "chunked-csr-ef": dict(chunk_size=60_000, error_feedback=True),
         "flat-dense-masked-ef": dict(wire_format="dense_masked",
                                      error_feedback=True),
         "flat-fp16-ef-epochs-2": dict(wire_format="csr_q", q_dtype="fp16",
                                       error_feedback=True, epochs=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread a process: the suite runs in several worker
    processes at once, and more threads than cores only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(cell, engine, **kw):
    """The port's own initial LM from ``SEED``: resume is held against the
    port's uninterrupted run."""
    load_all()
    cfg = get_config("qwen2-1.5b").reduced(**LM_SMALL)
    return FedS3ATrainer(
        make_lm_dataset(8, **DATA),
        FedS3AConfig(model=cfg, device="cpu", engine=engine, **RUN,
                     **CELLS[cell], **kw))


_PORT = {}


def _port(cell, engine):
    """The uninterrupted run, made once a module."""
    if (cell, engine) not in _PORT:
        tr = _trainer(cell, engine)
        _PORT[cell, engine] = (tr, tr.train())
    return _PORT[cell, engine]


def trace(tr):
    return [(l.participants, dict(l.stalenesses), l.forced, l.lost,
             l.corrupted, l.departed, l.rejoined, l.resynced, l.quorum,
             l.target_k, l.degraded, l.deadline_hit, l.crashes, l.time,
             l.art) for l in tr.logs]


def _same_end(a, out_a, b, out_b):
    assert torch.equal(a._global_flat, b._global_flat)
    for x, y in zip(leaves(a.server_opt), leaves(b.server_opt), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(a.store.ring, b.store.ring)
    np.testing.assert_array_equal(a.base_versions, b.base_versions)
    np.testing.assert_array_equal(a.store.detached, b.store.detached)
    if a.cstore is not None:
        # the EF residuals: CSR pages (chunked) or dense rows (flat)
        for x, y in zip(a.cstore._arrays, b.cstore._arrays, strict=True):
            assert torch.equal(x, y)
    assert trace(a) == trace(b)
    assert out_a == out_b
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert a.comm.ledger_state() == b.comm.ledger_state()
    assert a.seed_rng.bit_generator.state == b.seed_rng.bit_generator.state
    np.testing.assert_array_equal(a.participation, b.participation)


@pytest.mark.parametrize("wait", [True, False], ids=["wait", "background"])
@pytest.mark.parametrize("cell, engine", [
    ("flat-csr", "sequential"), ("flat-csr", "batched"),
    ("chunked-csr-ef", "batched"), ("flat-dense-masked-ef", "sequential"),
    ("flat-fp16-ef-epochs-2", "batched")])
def test_lm_resume_is_bit_exact(cell, engine, wait, tmp_path):
    """Train 3 faulted rounds and save; restore onto a fresh trainer and
    train 3 more: the end state is the uninterrupted run's bit for bit
    (parameters, the server's Adam state, which on the flat sequential
    engine is the LM's nested tree of dicts and lists, ring, versions,
    detached mask, EF pages, trace, ACO, fleet dict, metrics, every RNG
    stream). A background save is followed at once by a round that
    overwrites the ring and the residuals in place."""
    whole, out_whole = _port(cell, engine)
    first = _trainer(cell, engine, checkpoint_dir=str(tmp_path))
    for _ in range(ROUNDS // 2):
        first.run_round()
    first.save_checkpoint(wait=wait)
    if not wait:
        first.run_round()
        first._ckpt_drain()
    second = _trainer(cell, engine, checkpoint_dir=str(tmp_path))
    assert second.restore() == ROUNDS // 2
    out = second.train(ROUNDS - ROUNDS // 2)
    _same_end(whole, out_whole, second, out)
    if engine == "sequential":
        assert isinstance(second.server_opt["m"]["prefix"], list)
    fleet = out_whole["fleet"]
    assert fleet["crashes"] and fleet["resyncs"] and fleet["quarantined"]
