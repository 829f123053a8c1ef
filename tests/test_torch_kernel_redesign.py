"""The arithmetic and protocol of two CUDA kernels, emulated on the CPU.

The kernels run only on the card, where ``chip_smoke.py`` holds their
output bit for bit against the plain versions. Here:

- ``masked_pseudo_ce``'s backward kernel (``csrc/masked_pseudo_ce.cu``):
  a float32 emulation of its arithmetic (torch.softmax's sum order on the
  card, an IEEE division, argmax ties to the first index) against the
  reference's ``_mpce_bwd`` (``repro/kernels/ops.py:51-58``);
- ``csr_compact``'s single pass with decoupled look-back
  (``csrc/csr_compact.cu``): a numpy model of its blocks, run under a
  random interleaving, against the port's and the reference's
  ``csr_compact2d_ref``.
"""
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

THETA = 0.95


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


# -- masked_pseudo_ce backward ---------------------------------------------
def emulate_backward(x, mask, g):
    """The backward kernel's arithmetic in float32: W = min(next_pow2(C),
    32) lane sums of exp(x - max), each over j = l, l + W, ... in order,
    then an xor butterfly from offset W / 2 down to 1; p = e / sum; argmax
    ties to the first index; (p - onehot) * (mask * g)."""
    n, c = x.shape
    width = 1 << (c - 1).bit_length()
    lanes = min(width, 32)
    m = x.max(dim=1).values
    e = torch.exp(x - m[:, None])
    padded = torch.cat([e, e.new_zeros((n, width - c))], dim=1)
    part = padded[:, :lanes]
    for it in range(1, width // lanes):
        part = part + padded[:, it * lanes:(it + 1) * lanes]
    off = lanes // 2
    while off:
        part = part[:, :off] + part[:, off:2 * off]
        off //= 2
    p = e / part[:, :1]
    cols = torch.arange(c).expand(n, c)
    arg = torch.where(x == m[:, None], cols, c).min(dim=1).values
    onehot = (cols == arg[:, None]).to(torch.float32)
    return (p - onehot) * (mask * g)[:, None]


LOGIT_CASES = {"seq": (100, 9, 0), "batched": (600, 9, 1),
               "wide": (300, 40, 2), "ties": (600, 9, 3),
               "at_threshold": (512, 9, 4)}


def _logits(case):
    n, c, seed = LOGIT_CASES[case]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, c)) * 3).astype(np.float32)
    if case == "ties":
        # the max twice (or three times) in a row, at varied places
        x[:, 5] = x.max(axis=1)
        x[::2, 2] = x[::2, 5]
        x[::3, 8] = x[::3, 5]
        x[1::4] = np.round(x[1::4])
    elif case == "at_threshold":
        # max softmax within 1e-4 of theta on either side: logits
        # (0, b x 8) with 1 / (1 + 8 e^b) = theta (1 + d)
        d = np.linspace(-1e-4, 1e-4, n)
        b = np.log((1 / (THETA * (1 + d)) - 1) / 8)
        x = np.zeros((n, c), np.float32)
        x[:, 1:] = b.astype(np.float32)[:, None]
        x[:, 0] = rng.standard_normal(n).astype(np.float32) * 1e-3
    return x, rng.random(len(x)).astype(np.float32)


@pytest.mark.parametrize("case", list(LOGIT_CASES))
def test_backward_emulation_matches_reference_vjp(case):
    """The emulation against ``_mpce_bwd`` at atol 1e-6 (|p| <= 1, so a few
    ulps of float32 at 1 are < 1e-6), from the same mask: the Pallas
    forward's, in interpret mode. The plain version too."""
    x, g = _logits(case)
    _, jmask = jops.masked_pseudo_ce(jnp.asarray(x), THETA)
    mask = np.array(jmask)
    if case == "at_threshold":
        assert 0 < mask.sum() < len(mask)        # rows on both sides
    (want,) = jops._mpce_bwd(THETA, (jnp.asarray(x), jnp.asarray(mask)),
                             (jnp.asarray(g), None))
    xt, mt, gt = (torch.from_numpy(a) for a in (x, mask, g))
    got = emulate_backward(xt, mt, gt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    plain = ops.masked_pseudo_ce_grad(xt, mt, gt)
    np.testing.assert_array_equal(plain.numpy(),
                                  ref.masked_pseudo_ce_grad(xt, mt, gt))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                               rtol=0)


def test_backward_ties_go_to_the_first_index():
    x, g = _logits("ties")
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = emulate_backward(xt, torch.ones(len(x)), gt).numpy()
    tied = x == x.max(axis=1, keepdims=True)
    assert (tied.sum(axis=1) > 1).sum() > len(x) // 2
    rows, first = np.arange(len(x)), x.argmax(axis=1)   # the first maximum
    later = tied.copy()
    later[rows, first] = False
    assert (got[rows, first] < 0).all() and (got[later] > 0).all()
    want = jops._mpce_bwd(THETA, (jnp.asarray(x), jnp.ones(len(x))),
                          (jnp.asarray(g), None))[0]
    np.testing.assert_array_equal(np.asarray(want).argmin(axis=1), first)


def test_backward_sum_order_is_not_the_sequential_one():
    """What makes the order part of the kernel: on random rows the
    butterfly's sum and a left-to-right sum of the same float32
    exponentials differ in the last bit on some rows."""
    x, _ = _logits("batched")
    e = torch.exp(torch.from_numpy(x) - torch.from_numpy(x).max(
        dim=1, keepdim=True).values)
    seq = e[:, 0].clone()
    for j in range(1, e.shape[1]):
        seq = seq + e[:, j]
    pad = torch.cat([e, e.new_zeros((e.shape[0], 7))], dim=1)
    tree = pad
    for off in (8, 4, 2, 1):
        tree = tree[:, :off] + tree[:, off:2 * off]
    assert bool((tree[:, 0] != seq).any())


def test_backward_wrapper_checks_and_cpu_route():
    x = torch.zeros((4, 9))
    with pytest.raises(ValueError):
        ops.masked_pseudo_ce_grad(x, torch.ones(3), torch.ones(4))
    with pytest.raises(TypeError):
        ops.masked_pseudo_ce_grad(x.int(), torch.ones(4), torch.ones(4))
    with pytest.raises(TypeError):
        ops.masked_pseudo_ce_grad(x, torch.ones(4).double(), torch.ones(4))
    # logits of another float dtype: read as their float32 cast, the
    # gradient returned in their dtype, as the reference's kernel does
    xd = torch.randn((4, 9), dtype=torch.float64)
    gd = ops.masked_pseudo_ce_grad(xd, torch.ones(4), torch.ones(4))
    assert gd.dtype == torch.float64
    assert torch.equal(gd, ops.masked_pseudo_ce_grad(
        xd.float(), torch.ones(4), torch.ones(4)).double())
    # wider than the narrow kernels: the CPU runs the plain version
    wide = torch.randn((4, ops.MPCE_BWD_MAX_C + 1))
    np.testing.assert_array_equal(
        ops.masked_pseudo_ce_grad(wide, torch.ones(4), torch.ones(4)),
        ref.masked_pseudo_ce_grad(wide, torch.ones(4), torch.ones(4)))
    # autograd hands the backward a strided g; the wrapper takes it whole
    xt = torch.randn((6, 9), requires_grad=True)
    loss, _ = ops.masked_pseudo_ce(xt, 0.5)
    (grad,) = torch.autograd.grad(loss.mean(), xt)
    _, mask = ref.masked_pseudo_ce_ref(xt.detach(), 0.5)
    np.testing.assert_array_equal(grad, ref.masked_pseudo_ce_grad(
        xt.detach(), mask, torch.full((6,), 1 / 6)))


# -- csr_compact: the single-pass protocol ---------------------------------
AGGREGATE, PREFIX = 1, 2


class LookBackModel:
    """The state ``ops.csr_compact`` keeps across calls (flag words and the
    ticket counter on one stream) and the kernel's blocks, in numpy.

    A flag word is ``epoch << 34 | status << 32 | count``. Blocks draw
    tickets in the order they start; ``run`` interleaves their steps at
    random, at most ``resident`` at a time, so a block that waits on a
    flag yields and is retried later. Every read or write of a flag word is
    one step."""

    def __init__(self, tile, window=32):
        self.tile, self.window = tile, window
        self.words = np.zeros(0, dtype=np.int64)
        self.counter = self.drawn = self.epoch = 0

    def _block(self, x, thr, cap, nblk, tag, out):
        t = self.counter - self.drawn
        self.counter += 1
        k, j = divmod(t, nblk)
        yield                                   # its loads are in flight
        base = j * self.tile
        seg = x[k, base:base + self.tile]
        keep = (np.abs(seg) >= thr[k]) & (seg != 0)
        count = int(keep.sum())
        row = k * nblk
        if j == 0:
            self.words[row] = tag | PREFIX << 32 | count
            excl = 0
            yield
        else:
            self.words[row + j] = tag | AGGREGATE << 32 | count
            yield
            excl, top = 0, j - 1
            while True:
                # the warp's 32 loads; q < 0 reads as a prefix of 0
                flags = [int(self.words[row + q]) if q >= 0
                         else tag | PREFIX << 32
                         for q in range(top, top - self.window, -1)]
                yield
                ready = [f >> 34 == tag >> 34 and f >> 32 & 3 != 0
                         for f in flags]
                prefix = [r and f >> 32 & 3 == PREFIX
                          for r, f in zip(ready, flags)]
                need = prefix.index(True) + 1 if any(prefix) else \
                    self.window
                if not all(ready[:need]):
                    continue                      # spin on the same window
                excl += sum(f & 0xFFFFFFFF for f in flags[:need])
                if any(prefix):
                    break
                top -= self.window
            self.words[row + j] = tag | PREFIX << 32 | excl + count
            yield
        cols = np.flatnonzero(keep)
        pos = excl + np.arange(len(cols))
        fits = pos < cap
        out["vals"][k, pos[fits]] = seg[cols[fits]]
        out["idx"][k, pos[fits]] = base + cols[fits]
        out["writes"][k, pos[fits]] += 1
        # this tile's dropped columns own the slots [hi - dropped, hi)
        n = x.shape[1]
        hi = n - (base - excl)
        lo = hi - (len(seg) - count)
        zero = np.arange(lo, min(hi, cap))
        out["vals"][k, zero] = 0.0
        out["idx"][k, zero] = 0
        out["writes"][k, zero] += 1
        if j == nblk - 1:
            out["nnz"][k] = excl + count

    def run(self, x, thr, cap, rng, resident):
        K, n = x.shape
        nblk = -(-n // self.tile)
        tiles = K * nblk
        if self.words.size <= tiles:
            self.words = np.zeros(tiles + 1, dtype=np.int64)
            self.counter = self.drawn = self.epoch = 0
        self.epoch += 1
        tag = self.epoch << 34
        out = {"vals": np.full((K, cap), np.nan, np.float32),
               "idx": np.full((K, cap), -1, np.int32),
               "nnz": np.full(K, -1, np.int32),
               "writes": np.zeros((K, cap), np.int32)}
        waiting, live, steps = tiles, [], 0
        while waiting or live:
            if waiting and (len(live) < resident and
                            (not live or rng.random() < 0.3)):
                live.append(self._block(x, thr, cap, nblk, tag, out))
                waiting -= 1
                continue
            b = rng.choice(live)
            try:
                next(b)
            except StopIteration:
                live.remove(b)
            steps += 1
            assert steps < 200 * tiles * (nblk + 1), "the blocks deadlocked"
        self.drawn += tiles
        assert self.counter == self.drawn
        return out


def _delta(rng, K, n, zero_frac=0.1):
    x = rng.standard_normal((K, n)).astype(np.float32) * 1e-3
    x[rng.random((K, n)) < zero_frac] = 0.0
    return x


def _case(name, rng):
    K, n = {"ragged": (1, 3213), "multi_row": (3, 2000),
            "all_zero_row": (3, 1100), "one_column": (2, 1)}.get(
        name, (2, 2500))
    x = _delta(rng, K, n)
    thr = np.quantile(np.abs(x), 0.8, axis=1).astype(np.float32)
    cap = max(int(np.ceil(0.5 * n)), 1)
    if name == "overflow":
        cap = max(int(((np.abs(x) >= thr[:, None]) & (x != 0)).sum(
            axis=1).min()) // 3, 1)
    elif name == "thr_le_0":
        thr = np.array([0.0, -1.0], np.float32)
    elif name == "all_zero_row":
        x[1] = 0.0
    return x, thr, cap


@pytest.mark.parametrize("tile", [32, 96])
@pytest.mark.parametrize("name", ["ragged", "multi_row", "overflow",
                                  "thr_le_0", "all_zero_row", "one_column"])
def test_single_pass_protocol_is_bit_equal_to_the_oracles(name, tile):
    """Random interleavings of the blocks, three calls on one flag state
    (each call's stale flags must read as unpublished in the next): every
    slot of vals / idx written once, and the payload bit-equal to the
    port's and the reference's ``csr_compact2d_ref``."""
    rng = np.random.default_rng(tile)
    sched = random.Random(f"{name}-{tile}")
    x, thr, cap = _case(name, rng)
    model = LookBackModel(tile)
    x0, thr0, cap0 = _case("multi_row", rng)
    for xx, tt, cc in ((x0, thr0, cap0), (x, thr, cap),
                       (x, thr * np.float32(0.9), cap)):
        out = model.run(xx, tt, cc, sched, resident=sched.randint(1, 12))
        assert (out["writes"] == 1).all()
        jv, ji, jn = jref.csr_compact2d_ref(jnp.asarray(xx), jnp.asarray(tt),
                                            cc)
        tv, ti, tn = ref.csr_compact2d_ref(torch.from_numpy(xx),
                                           torch.from_numpy(tt), cc)
        for got, want in ((out["vals"], jv), (out["idx"], ji),
                          (out["nnz"], jn), (out["vals"], tv),
                          (out["idx"], ti), (out["nnz"], tn)):
            want = np.asarray(want)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def test_dropped_columns_own_the_zero_tail():
    """The zero ranges of a row's tiles partition [nnz, N): the first tile
    owns the top of the range, the last tile's run starts at nnz."""
    rng = np.random.default_rng(5)
    x = _delta(rng, 1, 1000)
    keep = (np.abs(x[0]) >= 5e-4) & (x[0] != 0)
    tile, n = 64, x.shape[1]
    owned, excl = [], 0
    for base in range(0, n, tile):
        count = int(keep[base:base + tile].sum())
        hi = n - (base - excl)
        owned.append((hi - (min(tile, n - base) - count), hi))
        excl += count
    assert owned[0][1] == n and owned[-1][0] == excl
    assert all(a[0] == b[1] for a, b in zip(owned, owned[1:]))


def test_tile_constant_matches_the_kernel_source():
    text = (build.CSRC / "csr_compact.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", text).group(1)) \
        == ops.CSR_TILE
    assert ops.CSR_TILE % 1024 == 0          # whole 32-chunk warp scans
    assert "masked_pseudo_ce_bwd" in ops.LAUNCHES
