"""Wrappers around the port's CUDA kernels. Port of
``repro/kernels/ops.py:29-118``.

Each wrapper checks its inputs, then picks by the tensor's device: a CPU
tensor takes the plain version in ``ref.py``; a CUDA tensor launches the
kernel (built on first use by ``build.py``) on the current stream, or
raises. There is no fallback from the card to the plain version.
``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do not
count), so a run can show that its path went through the kernels;
``LAUNCHES_BY_SHAPE`` splits the same counts by the call's (rows, width).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES = {"masked_pseudo_ce": 0, "masked_pseudo_ce_bwd": 0,
            "csr_compact": 0, "staleness_agg": 0, "sparse_delta": 0,
            "csr_quant": 0, "flash_attention": 0}
MPCE_BWD_MAX_C = ref.MPCE_WIDE_C   # torch.softmax's persistent-kernel
                                   # range; wider rows take the wide kernels
CSR_TILE = 8192           # kTile in csrc/csr_compact.cu
CSR_EPOCHS = 1 << 29      # epochs a flag word's bits 34-62 hold
CSRQ_TILE = 2048          # kTile in csrc/csr_quant.cu
CSRQ_EPOCHS = 1 << 31     # epochs an absmax word's bits 32-62 hold
Q_DTYPES = {"int8": torch.int8, "fp16": torch.float16}
FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # -> the kernel's bf16 flag
FLASH_HEAD_DIMS = (64, 128)
# the vocabulary-wide masked_pseudo_ce kernels (csrc/masked_pseudo_ce.cu)
WIDE_CLUSTER = 6                  # kCluster: blocks a row
WIDE_THREADS = 512                # kWideThreads: threads a block
WIDE_ALIGN = 4                    # kAlign: a slice is a multiple of 4 floats
WIDE_ON_CHIP = 227 * 1024 - 1024  # kOnChipBytes: a slice's copy at most


# (wrapper, rows, width) -> launches; width is the row's parameter count
# (csr_quant: n, not cap; flash_attention: rows B * S, width Hq * hd)
LAUNCHES_BY_SHAPE = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def _counted(name, rows, width):
    """One launch of ``name``'s kernel on a (rows, width) call."""
    LAUNCHES[name] += 1
    key = (name, int(rows), int(width))
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def _check(name, t, ndim, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _same_device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("inputs lie on different devices: "
                         + ", ".join(str(t.device) for t in ts))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _launch(fn_name, *args):
    err = build.kernel(fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed to launch: cudaError_t {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def wide_plan(c, cluster=WIDE_CLUSTER):
    """How the vocabulary-wide kernels (``c > MPCE_BWD_MAX_C``) split a
    row of ``c`` columns: ``cluster`` blocks (one thread-block cluster a
    row), block k owning columns ``bounds[k]`` (``slice`` columns each,
    ``ceil(c / cluster)`` rounded up to ``WIDE_ALIGN``, the last block the
    rest), and the ``smem_bytes`` of dynamic shared memory a block's copy
    of its slice takes; ``on_chip`` when that fits in ``WIDE_ON_CHIP``,
    else each pass reads the slice from device memory. The kernels are
    built at ``WIDE_CLUSTER``; another ``cluster`` describes a copy built
    at that size (``tools/wide_timeline.py --cluster``)."""
    q = -(-(-(-c // cluster)) // WIDE_ALIGN) * WIDE_ALIGN
    smem = 4 * (q + WIDE_ALIGN)
    return {"cluster": cluster, "slice": q,
            "bounds": [(min(c, k * q), min(c, (k + 1) * q))
                       for k in range(cluster)],
            "smem_bytes": smem, "on_chip": smem <= WIDE_ON_CHIP}


def _masked_pseudo_ce_fwd(logits, threshold):
    _check("logits", logits, 2)
    if not _same_device(logits):
        return ref.masked_pseudo_ce_ref(logits, threshold)
    n, c = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    mask = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n:
        _launch("masked_pseudo_ce_wide_launch" if c > MPCE_BWD_MAX_C
                else "masked_pseudo_ce_launch", logits.data_ptr(),
                loss.data_ptr(), mask.data_ptr(), n, c,
                ref.log_threshold(threshold), _stream(logits))
        _counted("masked_pseudo_ce", n, c)
    return loss, mask


class _MaskedPseudoCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, threshold):
        loss, mask = _masked_pseudo_ce_fwd(logits, threshold)
        ctx.save_for_backward(logits, mask)
        ctx.mark_non_differentiable(mask)
        # no zeros for the mask's gradient: one device op less a step
        ctx.set_materialize_grads(False)
        return loss, mask

    @staticmethod
    def backward(ctx, g_loss, _g_mask):
        if g_loss is None:
            return None, None
        logits, mask = ctx.saved_tensors
        return masked_pseudo_ce_grad(logits, mask, g_loss.contiguous()), None


def _float32_logits(logits):
    """Logits of any float dtype as float32 (the kernels' and the plain
    versions' type; a no-op for float32), as the reference's kernel casts
    its block (``repro/kernels/masked_pseudo_ce.py:24``). Differentiable:
    autograd casts the gradient back to the input's dtype."""
    if not isinstance(logits, torch.Tensor):
        raise TypeError(f"logits must be a torch.Tensor, got {type(logits)}")
    if not logits.is_floating_point():
        raise TypeError(f"logits must be a float tensor, got {logits.dtype}")
    return logits.to(torch.float32)


def masked_pseudo_ce(logits, threshold):
    """Eq. 5 (log-space mask): logits (N, C) of any float dtype, cast to
    float32 once -> (loss (N,), mask (N,)) float32. Differentiable in
    ``logits``, the gradient in their dtype; the backward is
    ``masked_pseudo_ce_grad``. Above ``MPCE_BWD_MAX_C`` classes both
    directions launch the kernels that take a thread-block cluster a row
    (``wide_plan``), whose bits are the float64-summed plain versions';
    their launches count under the same names, at their own (rows, C) in
    ``LAUNCHES_BY_SHAPE``."""
    return _MaskedPseudoCE.apply(_float32_logits(logits).contiguous(),
                                 threshold)


def masked_pseudo_ce_grad(logits, mask, g):
    """Backward of Eq. 5 (``repro/kernels/ops.py:51-58``): logits (N, C)
    of any float dtype (the kernel reads their float32 cast), mask (N,),
    g (N,) f32 -> ``(softmax - onehot(argmax)) * (mask * g)`` (N, C) in
    the logits' dtype, ties to the first index (the argmax of the cast is
    the input's: the cast is exact). The kernel gives the bits that
    ``ref.masked_pseudo_ce_grad`` gives on the card: up to 1024 classes
    torch.softmax's arithmetic, above it a cluster a row (``wide_plan``)
    summing in float64."""
    x = _float32_logits(logits).contiguous()
    _check("logits", x, 2)
    _check("mask", mask, 1)
    _check("g", g, 1)
    n, c = x.shape
    if mask.shape[0] != n or g.shape[0] != n:
        raise ValueError(f"shapes disagree: logits {tuple(x.shape)}, "
                         f"mask {tuple(mask.shape)}, g {tuple(g.shape)}")
    if not _same_device(x, mask, g):
        return ref.masked_pseudo_ce_grad(logits, mask, g)
    grad = torch.empty_like(x)
    if n and c:
        _launch("masked_pseudo_ce_wide_bwd_launch" if c > MPCE_BWD_MAX_C
                else "masked_pseudo_ce_bwd_launch", x.data_ptr(),
                mask.data_ptr(), g.data_ptr(), grad.data_ptr(), n, c,
                _stream(x))
        _counted("masked_pseudo_ce_bwd", n, c)
    return grad.to(logits.dtype)


_csr_state = {}   # (device, stream) -> [flag words + counter, drawn, epoch]


def _csr_workspace(x, stream, tiles):
    """``csr_compact``'s look-back state on ``x``'s device and ``stream``:
    int64 words, one flag a tile and the ticket counter last, with the
    tickets drawn from the counter so far and a new epoch for this call.
    The words are made zero on first use, when a call needs more tiles or
    when the epochs run out, and never reset otherwise."""
    key = (x.device, stream)
    state = _csr_state.get(key)
    if state is None or state[0].numel() <= tiles or \
            state[2] + 1 >= CSR_EPOCHS:
        state = [torch.zeros(tiles + 1, dtype=torch.int64, device=x.device),
                 0, 0]
        _csr_state[key] = state
    state[2] += 1
    return state


def csr_compact(x, thresholds, cap):
    """(K, N) f32 rows x (K,) f32 thresholds -> the CSR wire payload
    (values (K, cap) f32, indices (K, cap) int32, true nnz (K,) int32);
    survivors ``(|x| >= thr) & (x != 0)`` packed in column order, rank >=
    cap dropped, slots past ``min(nnz, cap)`` zero."""
    _check("x", x, 2)
    _check("thresholds", thresholds, 1)
    K, N = x.shape
    cap = int(cap)
    if thresholds.shape[0] != K:
        raise ValueError(f"thresholds has {thresholds.shape[0]} entries for "
                         f"{K} rows")
    if not 1 <= cap <= N:
        raise ValueError(f"cap must lie in [1, N={N}], got {cap}")
    if not _same_device(x, thresholds):
        return ref.csr_compact2d_ref(x, thresholds, cap)
    if K > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {K}")
    tiles = K * -(-N // CSR_TILE)
    vals = torch.empty((K, cap), dtype=torch.float32, device=x.device)
    idx = torch.empty((K, cap), dtype=torch.int32, device=x.device)
    nnz = torch.empty(K, dtype=torch.int32, device=x.device)
    if K:
        stream = _stream(x)
        state = _csr_workspace(x, stream, tiles)
        words = state[0]
        _launch("csr_compact_launch", x.data_ptr(), thresholds.data_ptr(),
                vals.data_ptr(), idx.data_ptr(), nnz.data_ptr(),
                words.data_ptr(),
                words.data_ptr() + 8 * (words.numel() - 1), state[1],
                state[2] << 34, K, N, cap, stream)
        state[1] += tiles
        _counted("csr_compact", K, N)
    return vals, idx, nnz


_csrq_state = {}   # (device, stream) -> [words, starts, arrivals, epoch]
_csrq_blocks = {}  # (device, fp16) -> co-resident blocks of the kernel


def _csrq_workspace(dev, stream, k, nblk):
    """``csr_quant``'s scratch on ``dev`` and ``stream``: int64 words, the
    barrier's arrival counter and then one absmax word a row, and int32
    room for the block starts (k, nblk + 1); with the arrivals of the calls
    so far and a new epoch for this call. The words are made zero on first
    use, when a call needs more room or when the epochs run out, and never
    reset otherwise; they never share memory with the starts, so a row's
    word holds nothing but absmax words of earlier epochs."""
    key = (dev, stream)
    state = _csrq_state.get(key)
    if state is None or state[0].numel() < 1 + k or \
            state[1].numel() < k * (nblk + 1) or \
            state[3] + 1 >= CSRQ_EPOCHS:
        state = [torch.zeros(1 + k, dtype=torch.int64, device=dev),
                 torch.empty(k * (nblk + 1), dtype=torch.int32, device=dev),
                 0, 0]
        _csrq_state[key] = state
    state[3] += 1
    return state


def _csrq_grid(dev, fp16, tiles):
    """Blocks of one ``csr_quant`` launch: one a tile, at most as many as
    are resident on the card at once (the cooperative launch's limit)."""
    key = (dev, fp16)
    blocks = _csrq_blocks.get(key)
    if blocks is None:
        with torch.cuda.device(dev):
            blocks = build.kernel("csr_quant_blocks")(fp16)
        if blocks <= 0:
            raise RuntimeError(f"csr_quant_blocks failed: cudaError_t "
                               f"{-blocks}")
        _csrq_blocks[key] = blocks
    return min(blocks, tiles)


def csr_quantize(values, indices, stored, n, *, q_dtype="int8"):
    """Quantize and index-pack compacted CSR rows, the ``csr_q`` wire:
    (values (K, cap) f32, indices (K, cap) int32 ascending in each stored
    prefix, stored (K,) int32) -> (qvals (K, cap) int8 | f16, offsets
    (K, cap) int16, block_counts (K, ceil(n/512)) int16, scales (K,) f32),
    the block counts over the stored prefix only. On the card one launch
    a call."""
    _check("values", values, 2)
    _check("indices", indices, 2, torch.int32)
    _check("stored", stored, 1, torch.int32)
    if q_dtype not in Q_DTYPES:
        raise ValueError(f"q_dtype must be one of {tuple(Q_DTYPES)}, got "
                         f"{q_dtype!r}")
    K, cap = values.shape
    if indices.shape != values.shape or stored.shape[0] != K:
        raise ValueError(f"shapes disagree: values {tuple(values.shape)}, "
                         f"indices {tuple(indices.shape)}, stored "
                         f"{tuple(stored.shape)}")
    n = int(n)
    if n < 1 or cap < 1:
        raise ValueError(f"n and cap must be positive, got n={n}, "
                         f"cap={cap}")
    if not _same_device(values, indices, stored):
        qvals, scales = ref.csr_quantize2d_ref(values, stored,
                                               q_dtype=q_dtype)
        offs, counts = ref.csr_pack_indices_ref(indices, stored, n)
        return qvals, offs, counts, scales
    dev = values.device
    nblk = max((n + ref.BLK - 1) // ref.BLK, 1)
    qvals = torch.empty((K, cap), dtype=Q_DTYPES[q_dtype], device=dev)
    offs = torch.empty((K, cap), dtype=torch.int16, device=dev)
    counts = torch.empty((K, nblk), dtype=torch.int16, device=dev)
    scales = torch.empty(K, dtype=torch.float32, device=dev)
    if K:
        fp16 = int(q_dtype == "fp16")
        grid = _csrq_grid(dev, fp16, K * -(-cap // CSRQ_TILE))
        stream = _stream(values)
        state = _csrq_workspace(dev, stream, K, nblk)
        words = state[0].data_ptr()
        _launch("csr_quant_launch", values.data_ptr(), indices.data_ptr(),
                stored.data_ptr(), qvals.data_ptr(), offs.data_ptr(),
                counts.data_ptr(), scales.data_ptr(), words + 8, words,
                state[1].data_ptr(), state[2], state[3] << 32, K, cap, nblk,
                fp16, grid, stream)
        state[2] += grid
        _counted("csr_quant", K, n)
    return qvals, offs, counts, scales


def sparse_delta_batch(x, thresholds):
    """(K, N) f32 stacked deltas x (K,) f32 thresholds -> (masked (K, N),
    per-512-column-block survivor counts (K, ceil(N/512)) int32) in one
    launch. Keeps ``|x| >= thr_k``, exact zeros included when ``thr_k <=
    0``; pad columns of the tail block never count."""
    _check("x", x, 2)
    _check("thresholds", thresholds, 1)
    K, N = x.shape
    if thresholds.shape[0] != K:
        raise ValueError(f"thresholds has {thresholds.shape[0]} entries for "
                         f"{K} rows")
    if not _same_device(x, thresholds):
        return ref.sparse_delta2d_ref(x, thresholds)
    if K > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {K}")
    nblk = (N + ref.BLK - 1) // ref.BLK
    masked = torch.empty_like(x)
    nnz = torch.empty((K, nblk), dtype=torch.int32, device=x.device)
    if K and N:
        _launch("sparse_delta_launch", x.data_ptr(), thresholds.data_ptr(),
                masked.data_ptr(), nnz.data_ptr(), K, N, nblk, _stream(x))
        _counted("sparse_delta", K, N)
    return masked, nnz


def sparse_delta(x, threshold):
    """The K = 1 form: (N,) f32 delta, a scalar threshold (float or 0-d / 1-
    element tensor) -> (masked (N,), counts (ceil(N/512),) int32)."""
    _check("x", x, 1)
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=x.device).reshape(1)
    masked, nnz = sparse_delta_batch(x.reshape(1, -1), thr)
    return masked.reshape(-1), nnz.reshape(-1)


def sparse_delta_topfrac(x, keep_frac):
    """Top-``keep_frac``-by-magnitude form: per-row sampled-quantile
    thresholds (``ref.local_quantile_thresholds``, plain PyTorch on the
    device, as the reference computes them in jnp) feed the kernel.
    Returns (masked (K, N), counts (K, ceil(N/512)), thresholds (K,))."""
    _check("x", x, 2)
    thr = ref.local_quantile_thresholds(x, keep_frac)
    masked, nnz = sparse_delta_batch(x, thr)
    return masked, nnz, thr


def staleness_agg(deltas, weights):
    """(K, N) f32 stacked deltas x (K,) f32 weights -> (N,) f32 weighted
    sum, accumulated over k in order."""
    _check("deltas", deltas, 2)
    _check("weights", weights, 1)
    K, N = deltas.shape
    if weights.shape[0] != K:
        raise ValueError(f"weights has {weights.shape[0]} entries for {K} "
                         f"rows")
    if not _same_device(deltas, weights):
        return ref.staleness_agg_ref(deltas, weights)
    out = torch.empty(N, dtype=torch.float32, device=deltas.device)
    if N:
        _launch("staleness_agg_launch", deltas.data_ptr(),
                weights.data_ptr(), out.data_ptr(), K, N, _stream(deltas))
        _counted("staleness_agg", K, N)
    return out


def flash_attention(q, k, v, *, window=None, causal=True):
    """Causal (optionally sliding-window) attention, the TPU flash kernel's
    function: q (B, S, Hq, hd), k / v (B, S, Hkv, hd) with Hq a multiple of
    Hkv (query head h reads KV head h // (Hq / Hkv), read in place), all
    bf16 or all float32 -> (B, S, Hq, hd) in q's dtype, computed in
    float32. ``window``: keys ``kp > qp - window`` only (causal only).
    The kernel takes hd in ``FLASH_HEAD_DIMS``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, H, hd), got shape "
                             f"{tuple(t.shape)}")
    if q.dtype not in FLASH_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{tuple(FLASH_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if v.shape != k.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV "
                         f"heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or positive, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if not _same_device(q, k, v):
        return ref.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {FLASH_HEAD_DIMS}, got "
                         f"{hd}")
    if B * Hq > 65535:
        raise ValueError(f"at most 65535 (batch, head) pairs per launch, "
                         f"got {B * Hq}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if B and S:
        # a window of S or more masks nothing more than causality does
        win = 0 if window is None or not causal else min(int(window), S)
        _launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, hd,
                FLASH_DTYPES[q.dtype], int(causal), win,
                1.0 / math.sqrt(hd), _stream(q))
        _counted("flash_attention", B * S, Hq * hd)
    return out
