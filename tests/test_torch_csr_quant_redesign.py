"""The one-launch protocol of the ``csr_quant`` CUDA kernel, modelled on the
CPU.

The kernel (``csrc/csr_quant.cu``) runs only on the card, where
``chip_smoke.py`` holds it bit for bit against the plain version. Here a
numpy model of its blocks runs on the wrapper's own workspace
(``ops._csrq_workspace``: the barrier's arrival counter, the epoch-tagged
absmax words, the block starts), under random interleavings: phase A over
each block's tiles, the grid barrier, phase B. Four calls share one
workspace that is never reset. The model's output is held bit for bit
against the port's plain version and the reference's Pallas kernel in
interpret mode, every block start must be written exactly once a call,
and phase B may read only what this call wrote.
"""
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.csr_quant import csr_quantize2d_pallas  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

BLK = 512
INV_127 = np.float32(1.0) / np.float32(127.0)


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def _block_of(col, nblk):
    """The kernel's block of a column: a column past the row's width (or a
    negative one, read unsigned) counts in none."""
    return min(int(np.uint32(np.int32(col))) >> 9, nblk)


class OneLaunchModel:
    """``csr_quant``'s blocks in numpy, on the wrapper's workspace for one
    (device, stream) key. ``tile`` slots a tile, ``threads`` a block (for
    the counts' grid-stride loop), ``cache_tiles`` the tiles with stored
    slots whose values a block keeps from phase A for phase B."""

    def __init__(self, tile, threads, key, cache_tiles=2):
        self.tile, self.threads, self.key = tile, threads, key
        self.cache_tiles = cache_tiles

    def _phase_a(self, t, a, out, cache):
        k, j = divmod(t, a["tpr"])
        cap, nblk = a["cap"], a["nblk"]
        live = min(max(int(a["stored"][k]), 0), cap)
        t0, t1 = j * self.tile, min((j + 1) * self.tile, cap)
        v = np.zeros(t1 - t0, np.float32)
        col = np.zeros(t1 - t0, np.int32)
        n_live = max(min(live, t1) - t0, 0)
        v[:n_live] = a["vals"][k, t0:t0 + n_live]
        col[:n_live] = a["idx"][k, t0:t0 + n_live]
        out["offs"][k, t0:t1] = np.where(np.arange(t0, t1) < live,
                                         col & (BLK - 1), 0)
        if a["fp16"]:
            out["q"][k, t0:t1] = v.astype(np.float16)
        elif t0 < live:
            if len(cache) < self.cache_tiles:
                cache.append(v.copy())
            else:
                cache.append(None)        # counted, not kept
        yield
        start, writes = a["start"], out["writes"]
        for s in range(t0, t0 + n_live):
            prev = -1 if s == 0 else _block_of(a["idx"][k, s - 1], nblk)
            cur = _block_of(col[s - t0], nblk)
            start[k, prev + 1:cur + 1] = s
            writes[k, prev + 1:cur + 1] += 1
        last = max(live - 1, 0)
        if t0 <= last < t0 + self.tile:
            frm = _block_of(a["idx"][k, live - 1], nblk) + 1 if live else 0
            start[k, frm:] = live
            writes[k, frm:] += 1
        yield
        if a["fp16"]:
            if j == 0:
                out["scales"][k] = 1.0
        elif t0 < live or j == 0:
            m = np.abs(v).max(initial=np.float32(0.0))
            word = a["tag"] | int(np.float32(m).view(np.uint32))
            a["absmax"][k] = max(int(a["absmax"][k]), word)

    def _phase_b(self, blk, grid, a, out, cache):
        nblk, nc = a["nblk"], a["K"] * a["nblk"]
        for first in range(blk * self.threads, nc, grid * self.threads):
            for i in range(first, min(first + self.threads, nc)):
                k, b = divmod(i, nblk)
                # the barrier opened only after every start was written
                assert (out["writes"][k, b:b + 2] == 1).all()
                out["counts"][k, b] = a["start"][k, b + 1] - \
                    a["start"][k, b]
            yield
        if a["fp16"]:
            return
        used = 0
        for t in range(blk, a["K"] * a["tpr"], grid):
            k, j = divmod(t, a["tpr"])
            word = int(a["absmax"][k])
            assert word >> 32 == a["tag"] >> 32, "no publish this call"
            scale = np.uint32(word & 0xFFFFFFFF).view(np.float32) * INV_127
            inv = np.float32(1.0) / scale if scale > 0 else np.float32(0.0)
            if j == 0:
                out["scales"][k] = scale
            cap = a["cap"]
            live = min(max(int(a["stored"][k]), 0), cap)
            t0, t1 = j * self.tile, min((j + 1) * self.tile, cap)
            v = np.where(np.arange(t0, t1) < live, a["vals"][k, t0:t1],
                         np.float32(0.0))
            if t0 < live:                 # the block's used-th stored tile
                kept = cache[used]
                used += 1
                if kept is not None:
                    v = kept
            r = np.fmin(np.fmax(np.rint(v * inv), np.float32(-127.0)),
                        np.float32(127.0))
            out["q"][k, t0:t1] = r.astype(np.int8)
            yield

    def _block(self, blk, grid, a, out):
        cache = []
        for t in range(blk, a["K"] * a["tpr"], grid):
            yield from self._phase_a(t, a, out, cache)
        a["words"][0] += 1                        # arrive
        while a["words"][0] < a["target"]:
            yield                                 # spin
        yield from self._phase_b(blk, grid, a, out, cache)

    def run(self, vals, idx, stored, n, q_dtype, grid, rng, stale=None):
        """One call; ``grid`` blocks at most (one a tile at least), all
        resident, stepped in a random order. ``stale``: a float written
        into row 0's absmax word under the previous call's epoch, as a
        word left by an earlier call would be."""
        K, cap = vals.shape
        nblk = max(-(-n // BLK), 1)
        tpr = -(-cap // self.tile)
        grid = max(min(grid, K * tpr), 1)
        state = ops._csrq_workspace(torch.device("cpu"), self.key, K, nblk)
        words = state[0].numpy()
        absmax = words[1:1 + K].view(np.uint64)
        start = state[1].numpy()[:K * (nblk + 1)].reshape(K, nblk + 1)
        if stale is not None:
            absmax[0] = np.uint64((state[3] - 1) << 32 | int(
                np.float32(stale).view(np.uint32)))
        fp16 = q_dtype == "fp16"
        a = {"vals": vals, "idx": idx, "stored": stored, "K": K, "cap": cap,
             "nblk": nblk, "tpr": tpr, "fp16": fp16, "words": words,
             "absmax": absmax, "start": start, "tag": state[3] << 32,
             "target": state[2] + grid}
        out = {"q": np.zeros((K, cap), np.float16 if fp16 else np.int8),
               "offs": np.zeros((K, cap), np.int16),
               "counts": np.zeros((K, nblk), np.int16),
               "scales": np.zeros(K, np.float32),
               "writes": np.zeros((K, nblk + 1), np.int32)}
        live = [self._block(b, grid, a, out) for b in range(grid)]
        steps = 0
        while live:
            b = rng.choice(live)
            try:
                next(b)
            except StopIteration:
                live.remove(b)
            steps += 1
            assert steps < 100 * grid * (K * tpr + K * nblk + 10), \
                "the blocks deadlocked"
        assert words[0] == state[2] + grid
        state[2] += grid
        assert (out["writes"] == 1).all(), "a block start written twice " \
            "or never"
        return out["q"], out["offs"], out["counts"], out["scales"]


def _payload(rng, K, n, keep=0.2, cap=None):
    """Real CSR payload rows: (values, indices, stored) from the plain
    csr_compact of update-sized deltas, a tenth exact zeros."""
    x = rng.standard_normal((K, n)).astype(np.float32) * 1e-3
    x[rng.random((K, n)) < 0.1] = 0.0
    xt = torch.from_numpy(x)
    cap = cap or max(1, int(np.ceil(2.5 * keep * n)))
    v, i, nnz = ref.csr_compact2d_ref(
        xt, ref.local_quantile_thresholds(xt, keep), cap)
    return v.numpy(), i.numpy(), np.minimum(nnz.numpy(), cap).astype(
        np.int32)


def _columns_in(rng, blocks, per_block, n):
    """Ascending columns, ``per_block`` of each listed 512-column block."""
    cols = [b * BLK + np.sort(rng.choice(min(BLK, n - b * BLK), per_block,
                                         replace=False)) for b in blocks]
    return np.concatenate(cols).astype(np.int32)


def _case(name, rng):
    """(values, indices, stored, n, q_dtype) of a named case."""
    q_dtype = "fp16" if name.startswith("fp16") else "int8"
    n = 5213                                     # 10 * 512 + 93: ragged
    if name == "cap_cut":
        v, i, s = _payload(rng, 2, n, cap=300)
        assert (s == 300).all()
    elif name in ("empty_runs", "fp16_empty_runs"):
        # empty blocks before (0-39), between (46-79) and after (86-100)
        n = 100 * BLK + 77
        cols = _columns_in(rng, [*range(40, 46), *range(80, 86)], 30, n)
        cap = len(cols) + 50
        v = np.zeros((2, cap), np.float32)
        i = np.zeros((2, cap), np.int32)
        v[:, :len(cols)] = rng.standard_normal((2, len(cols)))
        i[:, :len(cols)] = cols
        s = np.array([len(cols), len(cols) - 30], np.int32)
    else:
        v, i, s = _payload(rng, 3, n)
        if name == "stored_0":
            s[1] = 0
        elif name == "all_zero_row":
            v[2] = 0.0
        elif name == "one_block":
            i[0, :200] = _columns_in(rng, [7], 200, n)
            s[0] = 200
        elif name == "block_edge":
            # the prefix ends on the last column of block 4; and a row
            # that fills its capacity
            edge = int((i[0, :s[0]] < 5 * BLK).sum())
            i[0, edge - 1] = 5 * BLK - 1
            s[0] = edge
            s[1] = v.shape[1]
            i[1] = np.sort(rng.choice(n, v.shape[1], replace=False))
    return v, i, s, n, q_dtype


def _plain(v, i, s, n, q_dtype):
    qv, sc = ref.csr_quantize2d_ref(torch.from_numpy(v), torch.from_numpy(s),
                                    q_dtype=q_dtype)
    offs, counts = ref.csr_pack_indices_ref(torch.from_numpy(i),
                                            torch.from_numpy(s), n)
    return [t.numpy() for t in (qv, offs, counts, sc)]


def _pallas(v, i, s, n, q_dtype):
    return [np.asarray(t) for t in csr_quantize2d_pallas(
        jnp.asarray(v), jnp.asarray(i), jnp.asarray(s), n, q_dtype=q_dtype)]


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        got, want = (t.view(f"i{t.itemsize}") for t in (got, want))
    np.testing.assert_array_equal(got, want)


CASES = ["stored_0", "all_zero_row", "cap_cut", "one_block", "empty_runs",
         "block_edge", "ragged", "fp16_ragged", "fp16_empty_runs"]


@pytest.mark.parametrize("name", CASES)
def test_one_launch_protocol_is_bit_equal_to_the_oracles(name):
    """Four calls on one workspace, never reset (a warm-up payload, its
    first row alone, the case, the case scaled by 3 with a stale absmax
    word larger than its maximum): each bit-equal to the plain version, the
    case to the Pallas kernel in interpret mode too. A call with fewer rows
    before one with more is what would show absmax words and block starts
    sharing memory."""
    rng = np.random.default_rng(CASES.index(name))
    sched = random.Random(name)
    v, i, s, n, q_dtype = _case(name, rng)
    # the warm-up needs the most words, so no later call grows them
    v0, i0, s0 = _payload(rng, 3, 110 * BLK)
    model = OneLaunchModel(tile=64, threads=8, key=f"model-{name}")
    ops._csrq_state.pop((torch.device("cpu"), model.key), None)
    words = None
    for call, (vv, ii, ss, nn, stale) in enumerate((
            (v0, i0, s0, 110 * BLK, None),
            (v0[:1].copy(), i0[:1].copy(), s0[:1].copy(), 110 * BLK, None),
            (v, i, s, n, None), (v * np.float32(3.0), i, s, n, 1e30))):
        grid = sched.choice([1, 3, sched.randint(1, 1000)])
        got = model.run(vv, ii, ss, nn, q_dtype, grid, sched, stale=stale)
        state = ops._csrq_state[(torch.device("cpu"), model.key)]
        words = state[0] if words is None else words
        assert state[0] is words and state[3] == call + 1   # never reset
        for g, w in zip(got, _plain(vv, ii, ss, nn, q_dtype)):
            _same_bits(g, w)
        if call == 2:
            for g, w in zip(got, _pallas(vv, ii, ss, nn, q_dtype)):
                _same_bits(g, w)
    q, offs, counts, scales = got
    assert (counts.sum(axis=1) == np.clip(s, 0, v.shape[1])).all()
    if name == "stored_0":
        assert not counts[1].any() and not offs[1].any() and \
            scales[1] == 0.0
    if name == "all_zero_row":
        assert scales[2] == 0.0 and not q[2].any() and counts[2].any()
    if name == "one_block":
        assert counts[0, 7] == 200 and counts[0].sum() == 200
    if name.endswith("empty_runs"):
        assert not counts[:, :40].any() and not counts[:, 46:80].any() \
            and not counts[:, 86:].any()


def test_block_starts_partition_each_row():
    """The ranges (block(s - 1), block(s)] of the stored slots and the
    prefix's tail (block(last), nblk] cover [0, nblk] once each, whatever
    the gaps: the count of block b is start[b + 1] - start[b]."""
    rng = np.random.default_rng(3)
    nblk = 60
    for trial in range(20):
        live = int(rng.integers(0, 200))
        cols = np.sort(rng.integers(0, nblk * BLK, live))
        cover = np.zeros(nblk + 1, np.int32)
        start = np.full(nblk + 1, -1)
        prev = -1
        for s, c in enumerate(cols):
            cur = _block_of(c, nblk)
            cover[prev + 1:cur + 1] += 1
            start[prev + 1:cur + 1] = s
            prev = cur
        cover[prev + 1:] += 1
        start[prev + 1:] = live
        assert (cover == 1).all()
        np.testing.assert_array_equal(
            np.diff(start), np.bincount(cols // BLK, minlength=nblk))


def test_tile_and_block_constants_match_the_kernel_source():
    text = (build.CSRC / "csr_quant.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))
    assert const("kThreads") * const("kPerThread") == ops.CSRQ_TILE
    assert 1 << const("kBlkShift") == ref.BLK == BLK
    # the tag epoch << 32 must fit the kernel's signed 64-bit argument
    assert ops.CSRQ_EPOCHS <= 1 << 31
    # the ctypes argument list has as many entries as the C signature
    sig = re.search(r'extern "C" int csr_quant_launch\(([^)]*)\)',
                    text).group(1)
    assert len(build.SIGNATURES["csr_quant_launch"][1]) == \
        sig.count(",") + 1
    assert build.SIGNATURES["csr_quant_blocks"][0] == "csr_quant"


def test_workspace_is_kept_grown_and_renewed(monkeypatch):
    """The wrapper's scratch: words made zero on first use, kept (same
    tensors, epoch + 1) while they are large enough, made anew and zero
    when a call needs more rows or starts, or the epochs run out."""
    cpu, key = torch.device("cpu"), "workspace-test"
    ops._csrq_state.pop((cpu, key), None)
    s1 = ops._csrq_workspace(cpu, key, 6, 10184)
    assert s1[0].numel() == 7 and s1[1].numel() == 6 * 10185
    assert not s1[0].any() and s1[2:] == [0, 1]
    s1[0][0] = 7
    s1[2] = 7
    s2 = ops._csrq_workspace(cpu, key, 1, 10184)
    assert s2 is s1 and s2[3] == 2 and int(s2[0][0]) == 7
    s3 = ops._csrq_workspace(cpu, key, 7, 10184)
    assert s3 is not s1 and s3[2:] == [0, 1] and not s3[0].any()
    s4 = ops._csrq_workspace(cpu, key, 2, 40000)
    assert s4 is not s3 and s4[1].numel() == 2 * 40001
    monkeypatch.setattr(ops, "CSRQ_EPOCHS", 3)
    assert ops._csrq_workspace(cpu, key, 1, 2) is s4
    s5 = ops._csrq_workspace(cpu, key, 1, 2)
    assert s5 is not s4 and s5[3] == 1
    ops._csrq_state.pop((cpu, key), None)
