"""The port's ``PagedClientStore`` on the CPU: the unit contract of the
reference's own store (tests/test_client_store.py), one case each, then
random sequences of scatter, retire and gather driven through the
reference's store and the port's, whose windows must be equal; and the
paged encode, ``SparseComm.encode_paged``, bit for bit against ``encode``
with the page's dense expansion as the residual. ``ResidentStore``, the
resident layout behind the same interface, gives the dense paged store's
windows and rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.client_store import PagedClientStore as JStore  # noqa: E402
from repro_torch.configs.feds3a_cnn import CNNConfig  # noqa: E402
from repro_torch.core import PagedClientStore  # noqa: E402
from repro_torch.core.client_store import (LAYOUTS,  # noqa: E402
                                           ResidentStore,
                                           take_to_device)
from repro_torch.core.feds3a import FedS3AConfig, FedS3ATrainer  # noqa: E402
from repro_torch.core.sparse_comm import (SparseComm,  # noqa: E402
                                          csr_decode, csr_page_decode,
                                          flatten_tree, unflatten_like)
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

M, N, RCAP = 32, 40, 10


def _store(m=M, **kw):
    return PagedClientStore(m, N, RCAP, device="cpu", **kw)


def _csr_page(rng, k):
    vals = rng.normal(size=(k, RCAP)).astype(np.float32)
    idx = np.stack([rng.choice(N, RCAP, replace=False)
                    for _ in range(k)]).astype(np.int32)
    return vals, idx


def test_scatter_gather_round_trip_csr():
    rng = np.random.default_rng(0)
    st = _store()
    ids = [3, 7, 21]
    vals, idx = _csr_page(rng, len(ids))
    st.scatter_csr(ids, torch.from_numpy(vals), torch.from_numpy(idx))
    gv, gi = st.gather_csr(ids)
    assert isinstance(gv, torch.Tensor) and gv.device.type == "cpu"
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert np.array_equal(gv.numpy(), vals)
    assert np.array_equal(gi.numpy(), idx)


def test_scatter_gather_round_trip_dense():
    rng = np.random.default_rng(1)
    st = _store(layout="dense")
    ids = [0, 31]
    rows = rng.normal(size=(2, N)).astype(np.float32)
    st.scatter_dense(ids, rows)
    assert np.array_equal(st.gather_dense(ids).numpy(), rows)
    assert np.array_equal(st.residual_row(31), rows[1])


def test_unwritten_and_foreign_rows_read_zero():
    rng = np.random.default_rng(2)
    st = _store()
    vals, idx = _csr_page(rng, 1)
    st.scatter_csr([5], vals, idx)
    gv, gi = st.gather_csr([4, 5, 6])
    assert not gv.numpy()[[0, 2]].any()
    assert not gi.numpy()[[0, 2]].any()
    assert np.array_equal(gv.numpy()[1], vals[0])
    assert not st.residual_row(4).any()


def test_deferred_queue_order_scatter_then_retire_zeroes():
    rng = np.random.default_rng(3)
    st = _store()
    vals, idx = _csr_page(rng, 1)
    st.scatter_csr([9], vals, idx)
    st.retire([9])                       # a forced restart after the upload
    assert not st.residual_row(9).any()
    assert not st.valid[9]


def test_deferred_queue_order_retire_then_scatter_keeps_data():
    rng = np.random.default_rng(4)
    st = _store()
    vals, idx = _csr_page(rng, 1)
    st.retire([9])
    st.scatter_csr([9], vals, idx)
    assert st.residual_row(9).any()
    assert st.valid[9]


def test_residual_row_scatter_add_decodes_duplicate_columns():
    st = _store()
    vals = np.zeros((1, RCAP), np.float32)
    idx = np.zeros((1, RCAP), np.int32)
    vals[0, :3] = [1.0, 2.0, 4.0]
    idx[0, :3] = [7, 7, 12]              # a duplicate column adds
    st.scatter_csr([0], vals, idx)
    row = st.residual_row(0)
    assert row[7] == 3.0 and row[12] == 4.0
    assert row.sum() == 7.0


def test_memmap_pages_persist_under_paged_dir(tmp_path):
    rng = np.random.default_rng(5)
    st = _store(paged_dir=tmp_path)
    vals, idx = _csr_page(rng, 2)
    st.scatter_csr([1, 2], vals, idx)
    st.flush()
    assert isinstance(st.res_vals, np.memmap)
    on_disk = np.load(tmp_path / "res_vals.npy", mmap_mode="r")
    assert np.array_equal(np.asarray(on_disk[[1, 2]]), vals)
    gv, _ = st.gather_csr([1, 2])
    assert np.array_equal(gv.numpy(), vals)


def test_record_participation_counters():
    st = _store(layout="none")
    st.record_participation([2, 5], 0)
    st.record_participation([5], 3)
    assert st.part_count[5] == 2 and st.part_count[2] == 1
    assert st.last_round[5] == 3 and st.last_round[2] == 0
    assert st.last_round[0] == -1
    assert st.residual_store_bytes() == 0
    assert not st.residual_row(5).any()


def test_device_window_bytes_scale_with_k_not_m():
    rng = np.random.default_rng(6)
    small = _store()
    big = _store(100 * M)
    ids = [0, 1, 2, 3]
    for st in (small, big):
        vals, idx = _csr_page(rng, len(ids))
        st.scatter_csr(ids, vals, idx)
        st.gather_csr(ids)
    assert small.device_window_bytes() == big.device_window_bytes()
    assert big.host_bytes() > 50 * small.host_bytes()
    # queued write-back pages count as device bytes until they drain
    vals, idx = _csr_page(rng, len(ids))
    small.scatter_csr(ids, torch.from_numpy(vals), torch.from_numpy(idx))
    pending = small.device_window_bytes()
    assert pending > big.device_window_bytes()
    small.flush()
    assert small.device_window_bytes() < pending


def test_adopted_versions_count_toward_host_bytes():
    st = _store(layout="none")
    base = st.host_bytes()
    st.adopt_versions(np.zeros(M, np.int64), np.zeros(M, bool))
    assert st.host_bytes() == base + M * 8 + M


def test_rejects_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        _store(layout="sparse")
    assert LAYOUTS == ("csr", "dense", "none")


def test_trainer_rejects_paged_with_dense_base_store():
    data = make_dataset("basic", scale=0.0015, seed=0)
    cnn = CNNConfig(name="t", conv_filters=(8, 8), hidden=16)
    with pytest.raises(ValueError, match="paged"):
        FedS3ATrainer(data, FedS3AConfig(cnn=cnn, device="cpu",
                                         base_store="dense",
                                         client_store="paged"))
    with pytest.raises(ValueError, match="client_store"):
        FedS3ATrainer(data, FedS3AConfig(cnn=cnn, device="cpu",
                                         client_store="mapped"))


def test_state_dict_round_trip_keeps_only_valid_pages():
    rng = np.random.default_rng(7)
    st = _store()
    vals, idx = _csr_page(rng, 3)
    st.scatter_csr([1, 4, 8], vals, idx)
    st.retire([4])
    st.record_participation([1, 8], 2)
    snap = st.state_dict()
    assert snap["ids"].tolist() == [1, 8]
    other = _store()
    other.load_state_dict(snap)
    for i in range(M):
        np.testing.assert_array_equal(other.residual_row(i),
                                      st.residual_row(i))
    np.testing.assert_array_equal(other.part_count, st.part_count)
    with pytest.raises(ValueError, match="layout"):
        _store(layout="dense").load_state_dict(snap)


@pytest.mark.parametrize("layout", ["csr", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequences_match_the_reference_store(layout, seed):
    """Scatters, retirements and gathers in a random order, the same ops
    through both stores: every window, residual row and counter equal."""
    rng = np.random.default_rng(seed)
    ref = JStore(M, N, RCAP, layout=layout)
    port = _store(layout=layout)
    for step in range(60):
        op = rng.integers(4)
        ids = rng.choice(M, int(rng.integers(1, 6)), replace=False)
        if op == 0:
            if layout == "csr":
                vals, idx = _csr_page(rng, len(ids))
                ref.scatter_csr(ids, vals, idx)
                port.scatter_csr(ids, torch.from_numpy(vals),
                                 torch.from_numpy(idx))
            else:
                rows = rng.normal(size=(len(ids), N)).astype(np.float32)
                ref.scatter_dense(ids, rows)
                port.scatter_dense(ids, torch.from_numpy(rows))
        elif op == 1:
            ref.retire(ids)
            port.retire(ids)
        elif op == 2:
            ref.record_participation(ids, step)
            port.record_participation(ids, step)
        else:
            want = ref.gather_csr(ids) if layout == "csr" \
                else (ref.gather_dense(ids),)
            got = port.gather_csr(ids) if layout == "csr" \
                else (port.gather_dense(ids),)
            for w, g in zip(want, got, strict=True):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert port.device_window_bytes() == ref.device_window_bytes()
    for i in range(M):
        np.testing.assert_array_equal(port.residual_row(i),
                                      ref.residual_row(i))
    np.testing.assert_array_equal(port.valid, ref.valid)
    np.testing.assert_array_equal(port.part_count, ref.part_count)
    np.testing.assert_array_equal(port.last_round, ref.last_round)
    assert port.host_bytes() == ref.host_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_resident_store_gives_the_dense_paged_windows(seed):
    """The same random scatters, retirements and gathers through the
    resident store and the dense paged store: equal windows and rows; the
    resident store's device bytes are its whole (M, n) tensor."""
    rng = np.random.default_rng(seed)
    res = ResidentStore(M, N, device="cpu")
    pag = _store(layout="dense")
    for _ in range(60):
        op = rng.integers(3)
        ids = sorted(rng.choice(M, int(rng.integers(1, 6)), replace=False))
        if op == 0:
            rows = torch.from_numpy(
                rng.normal(size=(len(ids), N)).astype(np.float32))
            res.scatter_dense(ids, rows)
            pag.scatter_dense(ids, rows)
        elif op == 1:
            res.retire(ids)
            pag.retire(ids)
        else:
            assert torch.equal(res.gather_dense(ids), pag.gather_dense(ids))
    for i in range(M):
        np.testing.assert_array_equal(res.residual_row(i),
                                      pag.residual_row(i))
    assert res.device_window_bytes() == res.residual_store_bytes() == \
        M * N * 4


def test_take_to_device_reads_invalid_rows_as_zeros():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(8, 5)).astype(np.float32)
    rows = np.array([6, 1, 1, 4], np.int64)
    got = take_to_device(src, rows, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), src[rows])
    good = np.array([True, False, True, False])
    got = take_to_device(src, rows, torch.device("cpu"), good)
    want = src[rows] * good[:, None]
    np.testing.assert_array_equal(got.numpy(), want)


def test_store_seconds_count_drains_and_windows():
    st = _store(layout="dense")
    st.scatter_dense([1, 2], torch.ones(2, N))
    st.gather_dense([2, 3])
    assert st.seconds["drain_s"] > 0.0 and st.seconds["window_s"] > 0.0


@pytest.mark.parametrize("wire", ["csr", "csr_q"])
def test_encode_paged_is_encode_with_the_page_as_residual(wire):
    """A page from an EF encode decodes to the dense residual row the
    resident layout keeps, and ``encode_paged`` gives ``encode``'s delta,
    count and residual bit for bit."""
    g = torch.Generator().manual_seed(0)
    shapes = {"a": (30, 40), "b": (800,)}
    tree = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    base = {k: v + 0.01 * torch.randn(v.shape, generator=g)
            for k, v in tree.items()}
    n = sum(v.numel() for v in tree.values())
    comm = SparseComm("p0.2", wire_format=wire)
    rcap = comm.residual_capacity(n)
    # a residual as an EF encode leaves it: pages and their dense decode
    msg = torch.randn((1, n), generator=g) * 1e-3
    zero = torch.zeros_like(msg)
    _, _, _, (pv, pi) = comm.csr_core(msg, zero, zero, pages=True)
    _, _, _, dense = comm.csr_core(msg, zero, zero)
    assert pv.shape == (1, rcap)
    assert torch.equal(csr_page_decode(pv, pi, n), dense)
    assert torch.equal(csr_page_decode(torch.zeros_like(pv),
                                       torch.zeros_like(pi), n),
                       torch.zeros_like(dense))

    a, b = SparseComm("p0.2", wire_format=wire), \
        SparseComm("p0.2", wire_format=wire)
    d1, s1, r1 = a.encode(tree, base, residual=unflatten_like(dense[0],
                                                              tree))
    d2, s2, (rv, ri) = b.encode_paged(tree, base, pv[0], pi[0])
    assert torch.equal(flatten_tree(d1), flatten_tree(d2))
    assert int(s1["nnz"]) == int(s2["nnz"])
    assert torch.equal(flatten_tree(r1), csr_page_decode(rv[None],
                                                         ri[None], n)[0])
    assert a.aco == b.aco and a.messages == b.messages == 1
    # the page a compaction leaves: live slots are a nonzero prefix
    vals, idx, nnz = ops.csr_compact(msg.contiguous(),
                                     torch.full((1,), 1e-3), rcap)
    stored = torch.clamp(nnz, max=rcap)
    assert torch.equal(torch.count_nonzero(vals, dim=1), stored)
    assert torch.equal(csr_page_decode(vals, idx, n),
                       csr_decode(vals, idx, stored, n))
