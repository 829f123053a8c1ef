"""Fleet checkpoints in the port (``core/fleet_ckpt.py`` and the trainer's
``save_checkpoint`` / ``restore``), on the CPU: the encoding round-trips
every value the state holds (arrays of each dtype, integers wider than 64
bits, int keys, numpy and torch generator states); torn and corrupt
checkpoints fall back, retention keeps two, a foreign fingerprint is
refused; a faulted run resumed from a checkpoint ends bit for bit where an
uninterrupted one does (batched with resident EF, paged csr_q, chunked,
sequential), the chunked one also held against the reference's chunked
sequential engine under the same faults; a background save owns its
snapshot before the next round writes the state in place; a writer's
error surfaces at the next save; and a training subprocess killed with
SIGKILL resumes bit for bit."""
import dataclasses
import gc
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.feds3a_cnn import CNNConfig as JCNN  # noqa: E402
from repro.core import FedS3AConfig as JConfig  # noqa: E402
from repro.core import FedS3ATrainer as JTrainer  # noqa: E402
from repro.core import REFERENCE_CHURN as J_CHURN  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import REFERENCE_CHURN, fleet_ckpt  # noqa: E402
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(name="t", conv_filters=(8, 8), hidden=16, dropout=0.0)
SCALE, SEED, ROUNDS = 0.0015, 0, 8
FAULTS = dict(round_deadline=700.0, quorum_floor=2)
CHURN = dataclasses.replace(REFERENCE_CHURN, corrupt_prob=0.05)
CHUNK = dict(chunk_size=700, layer_keep_frac={"conv": 0.5, "out": 0.5})
CELLS = {
    "batched-resident-ef": dict(engine="batched", wire_format="csr",
                                error_feedback=True),
    "paged-csrq": dict(engine="batched", wire_format="csr_q",
                       error_feedback=True, client_store="paged"),
    "chunked": dict(engine="batched", wire_format="csr_q",
                    error_feedback=True, **CHUNK),
    "sequential": dict(engine="sequential", wire_format="csr_q",
                       error_feedback=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The models here are tiny: one intra-op thread a process. The suite
    runs in several worker processes at once, and more threads than cores
    in all only contend (several times the wall time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the encoding and the file protocol -------------------------------------
def test_codec_round_trips_every_state_value():
    g = np.random.default_rng(5)
    g.random(7)
    tg = torch.Generator().manual_seed(3)
    torch.rand(5, generator=tg)
    value = {
        "arrays": [np.zeros(0, np.float32), np.float16([1.5, -2]),
                   np.arange(6, dtype=np.int16).reshape(2, 3),
                   np.array([True, False]), np.array(2.5, np.float32),
                   np.int8([-128, 127]), np.uint8([0, 255]),
                   np.arange(12.0)[::3], np.int64([-(1 << 62)])],
        "tensor": torch.arange(6, dtype=torch.int32).reshape(3, 2),
        "big": (1 << 127) + 12345, "neg": -(1 << 100),
        "rng": g.bit_generator.state, "torch_gen": tg.get_state(),
        "int_keys": {3: "x", -1: [1, 2.5], (0, 1): None},
        "floats": [float("nan"), float("inf"), -0.0, 5e-324, 1 / 3],
        "bytes": b"\x00\xff", "__tagged": 1, "nested": {"a": {"b": []}},
    }
    out = fleet_ckpt.unpack(fleet_ckpt.pack(value))
    for a, b in zip(value["arrays"], out["arrays"], strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
        assert b.flags.writeable
    assert out["tensor"].dtype == np.int32 and \
        np.array_equal(out["tensor"], value["tensor"].numpy())
    assert out["big"] == value["big"] and out["neg"] == value["neg"]
    assert out["rng"] == g.bit_generator.state
    assert out["int_keys"] == value["int_keys"]
    assert out["bytes"] == b"\x00\xff" and out["__tagged"] == 1
    assert out["nested"] == {"a": {"b": []}}
    assert np.isnan(out["floats"][0]) and out["floats"][1:] == \
        value["floats"][1:]
    # the restored generators go on drawing what the originals draw
    g2 = np.random.default_rng()
    g2.bit_generator.state = out["rng"]
    assert g2.random() == g.random()
    t2 = torch.Generator()
    t2.set_state(torch.from_numpy(out["torch_gen"]))
    assert torch.equal(torch.rand(4, generator=t2),
                       torch.rand(4, generator=tg))
    logs = [fleet_ckpt.pack_element({"r": i, "s": {i: 0.5}})
            for i in range(3)]
    assert fleet_ckpt.unpack(fleet_ckpt.pack_array_of_packed(logs)) == \
        [{"r": i, "s": {i: 0.5}} for i in range(3)]
    for bad in (b"", b"junk" * 8, fleet_ckpt.pack(value)[:40]):
        with pytest.raises(ValueError):
            fleet_ckpt.unpack(bad)


def test_torn_and_corrupt_checkpoints_fall_back(tmp_path):
    root = str(tmp_path / "ck")
    fp = {"seed": 0}
    paths = [fleet_ckpt.write_checkpoint(
        root, r, {"a": {"x": np.full(4, r)}, "b": [r]}, fp)
        for r in (1, 2, 3)]
    # retention keeps the newest two
    assert [r for r, _ in fleet_ckpt.checkpoint_dirs(root)] == [2, 3]
    assert not os.path.exists(paths[0])
    path, manifest = fleet_ckpt.find_restorable(root)
    assert path == paths[2] and manifest["round"] == 3
    assert manifest["fingerprint"] == fp
    # a flipped byte in the newest section: the one before
    sec = os.path.join(paths[2], "a.ckpt")
    data = bytearray(open(sec, "rb").read())
    data[-1] ^= 1
    open(sec, "wb").write(bytes(data))
    assert fleet_ckpt.find_restorable(root)[0] == paths[1]
    assert fleet_ckpt.read_section(paths[1], "a")["x"].tolist() == [2] * 4
    # a torn manifest, then a missing section: nothing left
    man = os.path.join(paths[1], fleet_ckpt.MANIFEST_NAME)
    open(man, "wb").write(open(man, "rb").read()[:20])
    assert fleet_ckpt.find_restorable(root) == (None, None)
    assert fleet_ckpt.find_restorable(str(tmp_path / "none")) == (None, None)
    fleet_ckpt.write_checkpoint(root, 4, {"a": {"x": 1}}, fp)
    os.remove(os.path.join(root, "ckpt-00000004", "a.ckpt"))
    assert fleet_ckpt.find_restorable(root) == (None, None)


# -- resume, bit for bit ----------------------------------------------------
def _trainer(cell, ckpt, **kw):
    cfg = dict(rounds=ROUNDS, cnn=CNNConfig(**SMALL), seed=SEED,
               device="cpu", traffic=CHURN, checkpoint_dir=str(ckpt),
               **FAULTS, **CELLS[cell])
    cfg.update(kw)
    return FedS3ATrainer(make_dataset("basic", scale=SCALE, seed=SEED),
                         FedS3AConfig(**cfg), init_params=_init())


def _init():
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    return {n: np.asarray(v) for n, v in j_init_cnn(JCNN(**SMALL), k).items()}


def trace(tr):
    return [(l.participants, dict(l.stalenesses), l.forced, l.lost,
             l.corrupted, l.departed, l.rejoined, l.resynced, l.quorum,
             l.target_k, l.degraded, l.deadline_hit, l.crashes, l.time,
             l.art, l.metrics) for l in tr.logs]


def _residuals(tr):
    if tr.cstore is None or tr._ef_layout is None:
        return np.zeros(0)
    return np.stack([tr.cstore.residual_row(i) for i in range(tr.M)])


def _same_end(a, out_a, b, out_b):
    assert torch.equal(a._global_flat, b._global_flat)
    assert torch.equal(a.store.ring, b.store.ring)
    np.testing.assert_array_equal(a.base_versions, b.base_versions)
    np.testing.assert_array_equal(a.store.detached, b.store.detached)
    np.testing.assert_array_equal(_residuals(a), _residuals(b))
    if a.paged:
        for x, y in zip(a.cstore.state_dict()["pages"],
                        b.cstore.state_dict()["pages"], strict=True):
            np.testing.assert_array_equal(x, y)
    assert trace(a) == trace(b)
    assert out_a["aco"] == out_b["aco"] and out_a["fleet"] == out_b["fleet"]
    assert out_a["metrics"] == out_b["metrics"]
    assert out_a["art"] == out_b["art"]
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert a.comm.ledger_state() == b.comm.ledger_state()
    assert a.seed_rng.bit_generator.state == b.seed_rng.bit_generator.state
    np.testing.assert_array_equal(a.participation, b.participation)


_RUNS = {}


def _uninterrupted(cell, tmp_path):
    if cell not in _RUNS:
        tr = _trainer(cell, tmp_path / "whole")
        _RUNS[cell] = (tr, tr.train())
    return _RUNS[cell]


@pytest.mark.parametrize("cell", list(CELLS))
def test_resume_is_bit_exact(cell, tmp_path):
    """Train 8 faulted rounds; separately train 4, save, restore onto a
    fresh trainer and train 4 more: the two end states are equal bit for
    bit (parameters, ring, versions, detached mask, residual pages, the
    trace, ACO, fleet dict, metrics, every RNG stream)."""
    whole, out_whole = _uninterrupted(cell, tmp_path)
    first = _trainer(cell, tmp_path / "half")
    first.train(ROUNDS // 2)
    first.save_checkpoint()
    second = _trainer(cell, tmp_path / "half")
    assert second.restore() == ROUNDS // 2
    out = second.train(ROUNDS - ROUNDS // 2)
    _same_end(whole, out_whole, second, out)
    assert any(l.resynced for l in whole.logs) and \
        len({l.quorum for l in whole.logs}) > 1


def test_chunked_faulted_run_matches_reference(tmp_path):
    """The chunked stacked body under faults against the reference's
    chunked sequential engine (which runs the stacked body too): the trace,
    versions, detached mask and fleet dict exactly; metrics within 1e-4 and
    ACO within 2e-3 (the reference's own batched engine differs from its
    sequential one by 0 here, tests/test_torch_faults.py)."""
    port, got = _uninterrupted("chunked", tmp_path)
    ref = JTrainer(j_make_dataset("basic", scale=SCALE, seed=SEED),
                   JConfig(rounds=ROUNDS, cnn=JCNN(**SMALL), seed=SEED,
                           engine="sequential", wire_format="csr_q",
                           error_feedback=True, traffic=dataclasses.replace(
                               J_CHURN, corrupt_prob=0.05), **FAULTS,
                           **CHUNK))
    want = ref.train()
    assert port.layout.num_chunks == ref.layout.num_chunks > 1
    assert trace(port) == [t[:-1] + ({},) for t in trace(ref)]
    np.testing.assert_array_equal(port.base_versions, ref.base_versions)
    np.testing.assert_array_equal(port.store.detached, ref.store.detached)
    assert got["fleet"] == want["fleet"] and want["fleet"]["resyncs"]
    for m in want["metrics"]:
        assert abs(got["metrics"][m] - want["metrics"][m]) < 1e-4, m
    assert abs(got["aco"] - want["aco"]) < 2e-3
    assert port.comm.messages == ref.comm.messages


def test_restore_falls_back_and_refuses_foreign_checkpoints(tmp_path):
    tr = _trainer("batched-resident-ef", tmp_path, checkpoint_every=2)
    tr.train(4)              # checkpoints at rounds 2 and 4
    assert [r for r, _ in fleet_ckpt.checkpoint_dirs(str(tmp_path))] == \
        [2, 4]
    sec = tmp_path / "ckpt-00000004" / "store.ckpt"
    sec.write_bytes(sec.read_bytes()[:100])           # torn newest write
    assert _trainer("batched-resident-ef", tmp_path).restore() == 2
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _trainer("batched-resident-ef", tmp_path, seed=1).restore()
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _trainer("batched-resident-ef", tmp_path,
                 wire_format="csr_q").restore()
    with pytest.raises(FileNotFoundError):
        _trainer("batched-resident-ef", tmp_path / "empty").restore()


def _sections(path):
    return {name[:-5]: fleet_ckpt.read_section(path, name[:-5])
            for name in os.listdir(path) if name.endswith(".ckpt")}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("cell", ["batched-resident-ef", "chunked"])
def test_background_save_owns_its_snapshot(cell, tmp_path):
    """``save_checkpoint(wait=False)``, then a whole round before the writer
    starts: the checkpoint holds the state at the save (as a twin's
    synchronous save at the same round does), though the round wrote the
    ring and the residuals in place meanwhile."""
    twin = _trainer(cell, tmp_path / "sync")
    twin.train(3)
    want = _sections(twin.save_checkpoint(wait=True))
    tr = _trainer(cell, tmp_path / "async")
    tr.train(3)
    gate = threading.Event()
    submit = tr._ckpt_submit
    tr._ckpt_submit = lambda job: submit(lambda: (gate.wait(60), job()))
    path = tr.save_checkpoint(wait=False)
    ring = tr.store.ring.clone()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # the writer and a round interleave
    try:
        tr.run_round()
        assert not torch.equal(tr.store.ring, ring)
        gate.set()
        tr.run_round()
        tr._ckpt_drain()
    finally:
        sys.setswitchinterval(interval)
    assert tr._ckpt_queue.unfinished_tasks == 0
    _assert_same(_sections(path), want)


def test_the_writer_lets_go_of_its_snapshot_and_its_trainer(tmp_path):
    """A background save's job, with the device copies it owns, is dropped
    once written; a trainer that saved in the background is freed when the
    caller lets go of it, and its writer thread then ends."""
    tr = _trainer("batched-resident-ef", tmp_path)
    tr.train(1)
    jobs, submit = [], tr._ckpt_submit
    tr._ckpt_submit = lambda job: (jobs.append(weakref.ref(job)),
                                   submit(job))
    tr.save_checkpoint(wait=False)
    tr._ckpt_drain()
    gc.collect()
    assert len(jobs) == 1 and jobs[0]() is None
    writer, trainer = tr._ckpt_thread, weakref.ref(tr)
    del tr, submit
    gc.collect()
    assert trainer() is None
    writer.join(30)
    assert not writer.is_alive()


def test_writer_error_surfaces_at_the_next_save(tmp_path, monkeypatch):
    tr = _trainer("batched-resident-ef", tmp_path)
    tr.train(1)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(fleet_ckpt, "write_checkpoint", broken)
    tr.save_checkpoint(wait=False)
    with pytest.raises(OSError, match="disk full"):
        tr.save_checkpoint(wait=False)
    monkeypatch.undo()
    assert os.path.isdir(tr.save_checkpoint())       # the queue is clear


CHILD = textwrap.dedent("""
    import dataclasses, sys
    import torch
    from repro_torch.configs.feds3a_cnn import CNNConfig
    from repro_torch.core import REFERENCE_CHURN, FedS3AConfig, FedS3ATrainer
    from repro_torch.data import make_dataset
    ckpt, progress = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)        # as the test process computes
    tr = FedS3ATrainer(make_dataset("basic", scale=0.0015, seed=0),
                       FedS3AConfig(
        cnn=CNNConfig(conv_filters=(8, 8), hidden=16), seed=0,
        device="cpu", engine="batched", error_feedback=True,
        traffic=dataclasses.replace(REFERENCE_CHURN, corrupt_prob=0.15),
        round_deadline=700.0, quorum_floor=1, checkpoint_dir=ckpt,
        checkpoint_every=2))
    for _ in range(400):
        tr.train(1)
        with open(progress, "w") as f:
            f.write(str(tr.global_version))
""")


def _kill_cfg(ckpt):
    return FedS3AConfig(
        cnn=CNNConfig(conv_filters=(8, 8), hidden=16), seed=0, device="cpu",
        engine="batched", error_feedback=True,
        traffic=dataclasses.replace(REFERENCE_CHURN, corrupt_prob=0.15),
        round_deadline=700.0, quorum_floor=1, checkpoint_dir=str(ckpt),
        checkpoint_every=2)


def test_sigkill_mid_run_then_restore_is_bit_exact(tmp_path):
    """A training subprocess of the port (no JAX), killed with SIGKILL in
    the middle of its run, possibly mid-write: a fresh trainer restores
    whatever survived and, trained on, ends bit for bit where an
    uninterrupted run does (dropout on: the per-round seeds and the
    device generator come back with the checkpoint)."""
    ckpt, progress = tmp_path / "ck", tmp_path / "progress"
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.Popen([sys.executable, str(script), str(ckpt),
                              str(progress)], env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
    try:
        deadline, seen = time.time() + 120, 0
        while time.time() < deadline and seen < 5:
            assert child.poll() is None, child.stderr.read().decode()[-2000:]
            try:
                seen = int(progress.read_text() or 0)
            except (FileNotFoundError, ValueError):
                seen = 0
            time.sleep(0.02)
        assert seen >= 5, "the child made no progress"
    finally:
        os.kill(child.pid, signal.SIGKILL)
        child.wait()
        child.stderr.close()
    data = make_dataset("basic", scale=0.0015, seed=0)
    resumed = FedS3ATrainer(data, _kill_cfg(ckpt))
    restored = resumed.restore()
    assert restored >= 2
    out = resumed.train(3)
    whole = FedS3ATrainer(data, _kill_cfg(tmp_path / "whole"))
    out_whole = whole.train(restored + 3)
    _same_end(whole, out_whole, resumed, out)
