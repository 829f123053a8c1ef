"""The vocabulary-wide ``masked_pseudo_ce`` kernels' plan and arithmetic,
emulated on the CPU.

Above 1024 classes ``csrc/masked_pseudo_ce.cu`` takes a thread-block
cluster of ``ops.WIDE_CLUSTER`` blocks a row, each block one slice of
``ops.wide_plan(c)``. The kernels run only on the card, where
``chip_smoke.py`` holds them bit for bit against the plain versions. Here:
the plan against the kernel source's constants and rules; the index
bookkeeping of a block's copy (scalar head, bulk-copied middle, scalar
tail); and a numpy emulation of the cluster's order (per-thread float64
sums over a strided slice, warp butterflies, the blocks' partials added in
rank order, one rounding; (value, index) joins the same way) against
``ref._exp_sum``, ``torch.argmax`` and the plain versions, and at 1025
classes against the reference's Pallas kernel in interpret mode.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

THETA = 0.95
SOURCE = (build.CSRC / "masked_pseudo_ce.cu").read_text()
SMEM_LIMIT = 227 * 1024          # a block's shared memory on an H100
WIDTHS = (1025, 4096, 151_936, 202_048)
# the reference's wide tolerances (tests/test_torch_model_adapter.py)
WIDE_LOSS, WIDE_GRAD = 4e-6, 2e-6


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    ops.reset_launches()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def _constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, f"{name} not found in masked_pseudo_ce.cu"
    return eval(m.group(1))  # integer arithmetic on literals only


def _c_function(name):
    """A one-argument ``int c`` helper of the kernel source, as Python:
    its statements with integer division, ``4LL`` as 4."""
    m = re.search(rf"{name}\(int c\) \{{(.*?)\n\}}", SOURCE, re.S)
    assert m, f"{name} not found in masked_pseudo_ce.cu"
    body = m.group(1).replace("4LL", "4").replace("/", "//")
    body = re.sub(r"\bint (\w+) =", r"\1 =", body)
    body = body.replace("return", "_ret =").replace(";", "")
    consts = {k: _constant(k) for k in ("kCluster", "kAlign")}

    def fn(c):
        env = dict(consts, c=c, wide_slice=lambda cc: slice_rule(cc))
        exec("\n".join(line.strip() for line in body.splitlines()
                       if line.strip()), {}, env)
        return env["_ret"]
    return fn


slice_rule = _c_function("wide_slice")


def test_plan_constants_match_the_kernel_source():
    assert _constant("kCluster") == ops.WIDE_CLUSTER == 6
    assert _constant("kWideThreads") == ops.WIDE_THREADS
    assert _constant("kAlign") == ops.WIDE_ALIGN
    assert _constant("kOnChipBytes") == ops.WIDE_ON_CHIP
    assert ops.MPCE_BWD_MAX_C == ref.MPCE_WIDE_C == 1024
    smem = _c_function("wide_smem_bytes")
    for c in (*WIDTHS, 1026, 1027, 1028, 1031, 347_112, 347_113, 600_000,
              2**31 - 1):
        plan = ops.wide_plan(c)
        assert plan["slice"] == slice_rule(c), c
        assert plan["smem_bytes"] == smem(c), c
        assert plan["on_chip"] == (smem(c) <= _constant("kOnChipBytes")), c


@pytest.mark.parametrize("c", [*WIDTHS, 347_112, 347_113, 600_000])
def test_plan_partitions_the_row(c):
    plan = ops.wide_plan(c)
    bounds = plan["bounds"]
    assert plan["cluster"] == len(bounds) == 6
    assert bounds[0][0] == 0 and bounds[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # no block idles: every slice holds columns, all but the last exactly
    # the slice length, a multiple of 4 floats (16-byte boundaries line up)
    assert all(lo < hi for lo, hi in bounds)
    assert all(hi - lo == plan["slice"] for lo, hi in bounds[:-1])
    assert plan["slice"] % 4 == 0
    assert plan["smem_bytes"] == 4 * (plan["slice"] + 4)
    # the copy fits in a block's shared memory, beside ~0.5 KB of static
    # arrays, wherever the plan holds it on chip
    assert plan["on_chip"] == (c <= 347_112)
    if plan["on_chip"]:
        assert plan["smem_bytes"] + 1024 <= SMEM_LIMIT
    if c == 151_936:
        assert (plan["slice"], plan["smem_bytes"]) == (25_324, 101_312)
    if c == 202_048:   # llama4's vocabulary, the zoo's largest
        assert plan["on_chip"] and plan["smem_bytes"] == 134_720


def _copy_layout(offset, length, chunks):
    """The kernel's bookkeeping for a slice that starts ``offset`` floats
    past a 16-byte boundary: (head, nvec, pad, chunk ranges)."""
    head = min((4 - offset) % 4, length)
    nvec = (length - head) // 4
    pad = (4 - head) % 4
    vec = [nvec * k // chunks for k in range(chunks + 1)]
    ranges = [(0 if k == 0 else head + 4 * vec[k],
               length if k == chunks - 1 else head + 4 * vec[k + 1])
              for k in range(chunks)]
    return head, nvec, pad, vec, ranges


@pytest.mark.parametrize("c", [1025, 151_936])
def test_copy_bookkeeping_covers_each_column_once(c):
    """Every block of every row of an (8, c) call: the chunk ranges the
    max pass walks partition the slice, each bulk copy starts on a 16-byte
    boundary in both memories and moves whole float4s, and the copy stays
    inside the slice's dynamic shared memory."""
    chunks = _constant("kChunks")
    plan = ops.wide_plan(c)
    for r in range(8):
        for lo, hi in plan["bounds"]:
            offset = (r * c + lo) % 4
            head, nvec, pad, vec, ranges = _copy_layout(offset, hi - lo,
                                                        chunks)
            assert ranges[0][0] == 0 and ranges[-1][1] == hi - lo
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            for k in range(chunks):
                if vec[k + 1] > vec[k]:
                    assert (offset + head + 4 * vec[k]) % 4 == 0
                    assert (pad + head + 4 * vec[k]) % 4 == 0
            assert head + 4 * nvec <= hi - lo < head + 4 * nvec + 4
            assert pad + (hi - lo) <= plan["smem_bytes"] // 4


# -- the cluster's order, emulated -----------------------------------------
def _thread_sums(seg, head, threads):
    """(R, L) float64 slice -> (R, threads): thread t's sum as the kernels
    take it. Four partials, one a float4 lane, each over w = t, t +
    threads, ... in order (the middle starts ``head`` columns in, where
    the row reaches a 16-byte boundary); the head column t is partial 0's
    first term, the tail column t its last; then (p0 + p1) + (p2 + p3).
    Zeros past the end add exactly."""
    rows, length = seg.shape
    nvec = (length - head) // 4
    tail0 = head + 4 * nvec
    iters = -(-nvec // threads)
    mid = np.zeros((rows, iters * threads, 4))
    mid[:, :nvec] = seg[:, head:tail0].reshape(rows, nvec, 4)
    mid = mid.reshape(rows, iters, threads, 4)
    p = np.zeros((rows, threads, 4))
    p[:, :head, 0] += seg[:, :head]
    for it in range(iters):
        p = p + mid[:, it]
    p[:, :length - tail0, 0] += seg[:, tail0:]
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def _butterfly(v, join):
    """An xor butterfly over the last axis (32 lanes), offsets 16 to 1."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = join(v, tuple(a[..., lanes ^ off] for a in v))
    return v


def _block(values, threads, join, identity):
    """A block's reduction of its threads' values: a butterfly in each
    warp, then lane l of the first warp takes warp l's result (the
    identity past the last warp) and a butterfly again."""
    rows = values[0].shape[0]
    warps = threads // 32
    v = _butterfly(tuple(a.reshape(rows, warps, 32) for a in values), join)
    first = tuple(np.concatenate([a[:, :, 0], np.full((rows, 32 - warps), e,
                                                      dtype=a.dtype)], 1)
                  for a, e in zip(v, identity))
    return tuple(a[:, 0] for a in _butterfly(first, join))


def _add(a, b):
    return (a[0] + b[0],)


def emulate_exp_sum(e, c):
    """The kernels' sum of exp(x - max) over each row of ``e`` (R, c)
    float32, the rows of one 16-byte aligned tensor: per block of
    ``wide_plan(c)`` each thread's float64 sum (``_thread_sums``), the
    block's butterflies, the blocks' partials added in rank order from
    rank 0, one rounding to float32."""
    threads = ops.WIDE_THREADS
    rows = e.shape[0]
    total = None
    for lo, hi in ops.wide_plan(c)["bounds"]:
        part = np.empty(rows)
        offset = (np.arange(rows) * c + lo) % 4   # floats past a boundary
        for off in np.unique(offset):
            sel = offset == off
            seg = e[sel, lo:hi].astype(np.float64)
            head = min((4 - off) % 4, hi - lo)
            (part[sel],) = _block((_thread_sums(seg, head, threads),),
                                  threads, _add, (0.0,))
        total = part if total is None else total + part
    return total.astype(np.float32)


def _arg_join(a, b):
    """``arg_join`` of the kernel source on arrays of (value, index)."""
    (v, i), (v2, i2) = a, b
    n1, n2 = np.isnan(v), np.isnan(v2)
    take = np.where(n1, n2 & (i2 < i),
                    n2 | (v2 > v) | ((v2 == v) & (i2 < i)))
    return np.where(take, v2, v), np.where(take, i2, i)


def emulate_argmax(x):
    """The kernels' (max, argmax) of each row of ``x`` (R, c): each
    thread's join over its columns, the block's butterflies, the blocks'
    pairs joined in rank order from rank 0. The join picks from a total
    order (a NaN first, then the larger value, then the smaller index), so
    how a thread groups its columns (four float4 lanes, head and tail)
    does not change the pair; a thread here takes j = t, t + 512, ..."""
    rows, c = x.shape
    threads = ops.WIDE_THREADS
    int_max = np.iinfo(np.int32).max
    best = None
    for lo, hi in ops.wide_plan(c)["bounds"]:
        length = hi - lo
        iters = -(-length // threads)
        v = np.full((rows, threads), -np.inf, dtype=np.float32)
        i = np.full((rows, threads), int_max, dtype=np.int64)
        for it in range(iters):
            j = it * threads + np.arange(threads)
            ok = j < length
            jj = np.minimum(j, length - 1)
            v2 = np.where(ok, x[:, lo + jj], -np.inf).astype(np.float32)
            i2 = np.where(ok, lo + jj, int_max)
            v, i = _arg_join((v, i), (v2, np.broadcast_to(i2, v2.shape)))
        pair = _block((v, i), threads, _arg_join, (-np.inf, int_max))
        best = pair if best is None else _arg_join(best, pair)
    return best


def emulate_forward(x, threshold):
    """loss, mask as the forward kernel finishes a row (rank 0): m + log s,
    m - lse, the float32 threshold, -mask * max_logp."""
    m, _ = emulate_argmax(x)
    m = torch.as_tensor(m)
    xt = torch.as_tensor(x)
    s = torch.as_tensor(emulate_exp_sum(torch.exp(xt - m[:, None]).numpy(),
                                        x.shape[1]))
    max_logp = m - (m + torch.log(s))
    mask = (max_logp >= ref.log_threshold(threshold)).to(torch.float32)
    return -mask * max_logp, mask


def emulate_backward(x, mask, g):
    """Each block's slice of (exp(x - m) / s - onehot(argmax)) * (mask *
    g), from the cluster's m, argmax and s."""
    m, arg = emulate_argmax(x)
    xt = torch.as_tensor(x)
    e = torch.exp(xt - torch.as_tensor(m)[:, None])
    s = torch.as_tensor(emulate_exp_sum(e.numpy(), x.shape[1]))
    cols = torch.arange(x.shape[1])
    onehot = (cols[None, :] == torch.as_tensor(arg)[:, None]).to(torch.float32)
    return (e / s[:, None] - onehot) * (mask * g)[:, None]


def _rows(c, n, seed, scale=3.0):
    """(n, c) logits, every other row confident: one logit raised until
    its softmax probability passes theta (at ``scale`` 1) by a margin."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, c)) * scale).astype(np.float32)
    for r in range(0, n, 2):
        x[r, rng.integers(c)] += np.log(c) + 5.0
    return x


@pytest.mark.parametrize("c", [1025, 151_936])
def test_cluster_sum_order_gives_the_plain_sum(c):
    """64 seeded rows: the cluster's float64 order, rounded once, is
    ``ref._exp_sum``'s float32 sum bit for bit."""
    x = torch.as_tensor(_rows(c, 64, seed=c))
    m = x.max(dim=1).values
    e, want = ref._exp_sum(x, m)
    got = emulate_exp_sum(e.numpy(), c)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))
    # the float32 sum in the same order is another number: the float64
    # accumulation is what makes the bits order-free
    e32 = e.numpy()
    assert any(np.float32(sum(e32[r, lo:hi].sum(dtype=np.float32)
                              for lo, hi in ops.wide_plan(c)["bounds"]))
               != want[r].item() for r in range(64))


@pytest.mark.parametrize("c", [1025, 151_936, 600_000])
def test_cluster_argmax_join_ties_and_nans(c):
    """Ties across every slice boundary, ties between slices far apart,
    a NaN in a later slice and NaNs in two slices: the cluster's join
    gives ``torch.argmax``'s index (the first maximum, the first NaN) and
    ``torch.max``'s value."""
    bounds = ops.wide_plan(c)["bounds"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2 * len(bounds) + 6, c)).astype(np.float32)
    for k in range(1, len(bounds)):
        b = bounds[k][0]
        x[k, b - 1] = x[k, b] = 9.0                 # across boundary k
        x[len(bounds) + k, b] = 9.0                 # first of slice k ...
        x[len(bounds) + k, bounds[-1][1] - 1] = 9.0  # ... and the last one
    r = 2 * len(bounds)
    x[r, bounds[-1][0] + 3] = np.nan                # NaN in the last slice
    x[r, 5] = 9.0
    x[r + 1, bounds[5][0]] = np.nan                 # NaNs in two slices
    x[r + 1, bounds[2][1] - 1] = np.nan
    x[r + 2, :] = -np.inf                           # every column -inf
    x[r + 3, :] = 1.0                               # all equal
    x[r + 4, [bounds[2][0], bounds[-1][0]]] = np.inf
    x[r + 5, bounds[-1][1] - 1] = 9.0               # the last column
    v, i = emulate_argmax(x)
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(i, torch.argmax(xt, dim=1).numpy())
    np.testing.assert_array_equal(v, xt.max(dim=1).values.numpy())
    assert i[r + 1] == bounds[2][1] - 1 and i[r] == bounds[-1][0] + 3


@pytest.mark.parametrize("c", [1025, 151_936])
def test_emulated_kernels_give_the_plain_versions_bits(c):
    x = _rows(c, 16, seed=c + 1)
    b = ops.wide_plan(c)["bounds"]
    x[1, b[1][0] - 1] = x[1, b[1][0]] = x[1].max() + 1.0   # boundary tie
    x[3, b[-1][0]] = x[3, b[-1][0] - 1] = x[3].max()       # tie, later col
    xt = torch.as_tensor(x)
    loss, mask = emulate_forward(x, THETA)
    want_loss, want_mask = ref.masked_pseudo_ce_ref(xt, THETA)
    assert torch.equal(loss.view(torch.int32), want_loss.view(torch.int32))
    assert torch.equal(mask, want_mask)
    assert 0 < int(mask.sum()) < 16
    g = torch.as_tensor(np.linspace(0.5, 1.5, 16).astype(np.float32))
    grad = emulate_backward(x, want_mask, g)
    want = ref.masked_pseudo_ce_grad(xt, want_mask, g)
    assert torch.equal(grad.view(torch.int32), want.view(torch.int32))
    # a masked-out row's gradient is a signed zero: -0 at its argmax
    assert torch.signbit(grad[1, b[1][0] - 1]) and \
        not torch.signbit(grad[1, b[1][0]])


def test_emulated_kernels_against_the_pallas_kernel():
    """At 1025 classes, the reference's Pallas kernel in interpret mode
    and its gradient, as ``test_torch_model_adapter.py`` holds the plain
    versions, within that test's tolerances."""
    x = _rows(1025, 16, seed=3, scale=1.0)
    loss, mask = emulate_forward(x, THETA)
    jl, jm = jops.masked_pseudo_ce(jnp.asarray(x), THETA)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert mask.sum() > 0 and mask[1::2].sum() == 0
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), atol=WIDE_LOSS,
                               rtol=0)
    g = np.linspace(0.5, 1.5, 16).astype(np.float32)
    jgrad = jax.grad(lambda z: jnp.sum(jops.masked_pseudo_ce(z, THETA)[0]
                                       * g))(jnp.asarray(x))
    grad = emulate_backward(x, mask, torch.as_tensor(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                               atol=WIDE_GRAD, rtol=0)
    assert np.count_nonzero(grad.numpy()[1::2]) == 0


def test_a_refused_launch_raises(monkeypatch):
    """A launch function's non-zero ``cudaError_t`` (a cluster launch the
    card refuses, say) raises from ``ops._launch``; nothing runs in its
    place."""
    calls = []

    def refused(*args):
        calls.append(args)
        return 7
    monkeypatch.setattr(build, "kernel", lambda name: refused)
    with pytest.raises(RuntimeError, match="cudaError_t 7"):
        ops._launch("masked_pseudo_ce_wide_launch", 0, 0, 0, 16, 151_936,
                    -0.05, 0)
    with pytest.raises(RuntimeError, match="masked_pseudo_ce_wide_bwd"):
        ops._launch("masked_pseudo_ce_wide_bwd_launch", 0, 0, 0, 0, 16,
                    151_936, 0)
    assert len(calls) == 2
