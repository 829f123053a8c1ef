"""Plain PyTorch versions of the port's kernels (and of the CSR helpers the
comm layer runs beside them). Port of ``repro/kernels/ref.py``.

The wrappers in ``ops.py`` take these for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLK = 512                 # sparse_delta's count block (the TPU tile width)
QUANTILE_SAMPLE = 2048


def log_threshold(threshold):
    """log(theta) rounded to float32, as the TPU kernel computes it."""
    return float(torch.log(torch.tensor(threshold, dtype=torch.float32)))


MPCE_WIDE_C = 1024        # above this width the exp sums go in float64


def _exp_sum(x, m):
    """exp(x - m) per element in float32, and its row sums: in float32 up
    to ``MPCE_WIDE_C`` classes, as torch.softmax sums there; above it in
    float64, rounded to float32 once, so that the bits do not depend on
    the order of the additions (a vocabulary-wide kernel adds in its own
    order and gives the same float32 sum, unless the float64 one sits on
    a float32 rounding boundary)."""
    e = torch.exp(x - m[:, None])
    if x.shape[1] <= MPCE_WIDE_C:
        return e, e.sum(dim=1)
    return e, e.to(torch.float64).sum(dim=1).to(torch.float32)


def masked_pseudo_ce_ref(logits, threshold):
    """Paper Eq. 5 in log space, the TPU kernel's form
    (``repro/kernels/masked_pseudo_ce.py:23-30``):

        max_logp_i = m_i - (m_i + log sum_c exp(x_ic - m_i)),  m_i = max_c x_ic
        mask_i = [max_logp_i >= log theta],  loss_i = -mask_i * max_logp_i

    The reference's own jnp oracle compares ``exp(max_logp) >= theta``
    instead; rows at the threshold can fall either way between the two.
    logits: (N, C). Returns (loss (N,), mask (N,)) in float32. Above
    ``MPCE_WIDE_C`` classes the sum goes in float64 (``_exp_sum``).
    """
    x = logits.to(torch.float32)
    m = x.max(dim=1).values
    lse = m + torch.log(_exp_sum(x, m)[1])
    max_logp = m - lse
    mask = (max_logp >= log_threshold(threshold)).to(torch.float32)
    return -mask * max_logp, mask


def masked_pseudo_ce_grad(logits, mask, g):
    """Backward of Eq. 5 (``repro/kernels/ops.py:51-58``):
    ``(softmax - onehot(argmax)) * mask * g``, ties to the first index.
    Up to ``MPCE_WIDE_C`` classes the softmax is torch.softmax; above it
    ``exp(x - m) / s`` by IEEE division, with the float64-summed ``s`` of
    ``_exp_sum``."""
    x = logits.to(torch.float32)
    if x.shape[1] <= MPCE_WIDE_C:
        p = torch.softmax(x, dim=1)
    else:
        e, s = _exp_sum(x, x.max(dim=1).values)
        p = e / s[:, None]
    onehot = torch.nn.functional.one_hot(
        torch.argmax(x, dim=1), x.shape[1]).to(torch.float32)
    return ((p - onehot) * (mask * g)[:, None]).to(logits.dtype)


def sampled_quantile(x, q, *, fused="low"):
    """Per-row linear-interpolation quantile q of ``x`` (K, n) >= 0.

    Written out rather than ``torch.quantile`` so that it rounds as the
    reference does: the position ``q * (n - 1)`` and its weights in
    float32, and the blend ``low * lw + high * hw`` with one product left
    unrounded, because the reference backend contracts it into a fused
    multiply-add; here the sum is taken in float64. Which product is
    fused depends on the reference's form: the low one in its per-row
    (axis-1 or vmapped) quantile, the high one in its 1-D quantile of one
    message (``repro/core/sparse_comm.py:67-75``), so ``fused`` is "low"
    or "high"."""
    s = torch.sort(x.to(torch.float32), dim=1).values
    n = s.shape[1]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    lw = np.float32(1.0) - hw
    low, high = s[:, lo] * float(lw), s[:, hi] * float(hw)
    if fused == "low":
        low = s[:, lo].to(torch.float64) * float(lw)
    elif fused == "high":
        high = s[:, hi].to(torch.float64) * float(hw)
    else:
        raise ValueError(f"fused must be 'low' or 'high', got {fused!r}")
    return (low.to(torch.float64) + high.to(torch.float64)).to(torch.float32)


def local_quantile_thresholds(x, keep_frac, *, sample=QUANTILE_SAMPLE,
                              fused="low"):
    """(K,) per-row |.|-quantile thresholds from a strided ``sample``-point
    subsample: row k keeps roughly its top ``keep_frac`` by magnitude
    (``repro/kernels/sparse_delta.py:81``; ``fused`` as in
    ``sampled_quantile``)."""
    stride = max(x.shape[1] // sample, 1)
    return sampled_quantile(x[:, ::stride].abs(), 1.0 - keep_frac,
                            fused=fused)


def sparse_delta2d_ref(x, thresholds):
    """Batched §IV-F sparsification (``repro/kernels/ref.py:50-67``):
    x (K, N) stacked flat deltas, thresholds (K,). Keeps ``|x| >= thr_k``
    (exact zeros are kept too when ``thr_k <= 0``). Returns (masked (K, N),
    nnz (K, ceil(N/512)) int32), the survivors of each 512-column block;
    the tail block's pad columns never count."""
    K, n = x.shape
    keep = x.abs() >= thresholds.to(torch.float32).reshape(K, 1)
    masked = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    pad = (-n) % BLK
    if pad:
        keep = torch.cat([keep, keep.new_zeros((K, pad))], dim=1)
    nnz = keep.reshape(K, -1, BLK).sum(dim=2, dtype=torch.int32)
    return masked, nnz


def sparse_delta_ref(x, threshold):
    """The K = 1 case: x (N,), a scalar threshold -> (masked (N,), nnz
    (ceil(N/512),) int32)."""
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=x.device).reshape(1)
    masked, nnz = sparse_delta2d_ref(x.reshape(1, -1), thr)
    return masked.reshape(-1), nnz.reshape(-1)


def _keep(x, thresholds):
    thr = thresholds.to(torch.float32).reshape(-1, 1)
    return (x.to(torch.float32).abs() >= thr) & (x != 0)


def csr_compact2d_ref(x, thresholds, cap):
    """Compacted CSR wire rows (§IV-F). x: (K, N); thresholds: (K,).

    Keeps ``(|x| >= thr) & (x != 0)`` in ascending column order; rank >=
    cap falls off, slots past ``min(nnz, cap)`` are zero. Returns
    (values (K, cap) f32, indices (K, cap) int32, nnz (K,) int32) with
    ``nnz`` the true, uncapped count.
    """
    K, _ = x.shape
    keep = _keep(x, thresholds)
    slot = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    nnz = (slot[:, -1] + 1).to(torch.int32)
    rows, cols = torch.nonzero(keep & (slot < cap), as_tuple=True)
    s = slot[rows, cols].long()
    vals = torch.zeros((K, cap), dtype=torch.float32, device=x.device)
    idx = torch.zeros((K, cap), dtype=torch.int32, device=x.device)
    vals[rows, s] = x[rows, cols].to(torch.float32)
    idx[rows, s] = cols.to(torch.int32)
    return vals, idx, nnz


def csr_capped_mask_ref(x, thresholds, cap):
    """Dense twin of ``csr_decode_ref(*csr_compact2d_ref(...))``: survivors
    whose in-row rank fits the capacity, everything else zero. Returns
    (decoded (K, N) f32, stored (K,) int32)."""
    keep = _keep(x, thresholds)
    rank = torch.cumsum(keep.to(torch.int32), dim=1)
    decoded = torch.where(keep & (rank <= cap), x.to(torch.float32),
                          torch.zeros((), dtype=torch.float32,
                                      device=x.device))
    stored = torch.clamp(rank[:, -1], max=cap).to(torch.int32)
    return decoded, stored


def csr_decode_ref(values, indices, n):
    """Scatter-add decode of CSR rows back to dense (K, n) f32. Padding
    slots hold value 0 at index 0 and add nothing."""
    K = values.shape[0]
    out = torch.zeros((K, n), dtype=torch.float32, device=values.device)
    return out.scatter_add_(1, indices.long(), values.to(torch.float32))


INV_127 = float(np.float32(1.0) / np.float32(127.0))   # fl(1/127)


def _valid_slots(cap, stored, device):
    slot = torch.arange(cap, device=device)
    return slot[None] < stored.to(torch.int64).reshape(-1, 1)


def _inverse(scales):
    """1 / scale where scale > 0, else 0, as an IEEE division."""
    s = scales.to(torch.float32)
    one = torch.ones_like(s)
    return torch.where(s > 0, torch.div(one, torch.where(s > 0, s, one)),
                       torch.zeros_like(s))


def _round_clip(x):
    """round half to even, then clip to [-127, 127] (float32)."""
    return torch.clamp(torch.round(x), -127.0, 127.0)


def csr_quantize2d_ref(values, stored, *, q_dtype="int8"):
    """Per-row absmax quantization of packed CSR values, the ``csr_q``
    wire (``repro/kernels/ref.py:135-164``). values (K, cap) f32, stored
    (K,) live prefix lengths -> (qvals (K, cap) int8 | f16, scales (K,)
    f32). int8: ``scale = absmax * fl(1/127)`` over the stored prefix (the
    reference writes ``absmax / 127``, which its compiler turns into that
    product), ``q = clip(round_half_even(v * (1 / scale)), -127, 127)``;
    an all-zero row gets scale 0 and q 0. fp16: values cast with round to
    nearest even, scales all ones."""
    K, cap = values.shape
    valid = _valid_slots(cap, stored, values.device)
    v = torch.where(valid, values.to(torch.float32),
                    torch.zeros((), dtype=torch.float32,
                                device=values.device))
    if q_dtype == "fp16":
        return v.to(torch.float16), torch.ones(K, dtype=torch.float32,
                                               device=values.device)
    scale = v.abs().amax(dim=1) * INV_127
    q = _round_clip(v * _inverse(scale)[:, None])
    return q.to(torch.int8), scale


def csr_dequantize_ref(qvals, scales):
    """(K, cap) quantized values -> f32 ``q * scale`` (fp16 payloads carry
    all-one scales, so one expression serves both value types)."""
    return qvals.to(torch.float32) * scales.to(torch.float32)[:, None]


def quantize_dense_ref(dense, scales, *, q_dtype="int8"):
    """Elementwise quantize -> dequantize of a dense (K, n) stack under the
    per-row scales: the scatter-free twin of decoding a ``csr_q`` payload
    whose scales came from the same rows."""
    if q_dtype == "fp16":
        return dense.to(torch.float16).to(torch.float32)
    s = scales.to(torch.float32)[:, None]
    return _round_clip(dense.to(torch.float32) * _inverse(scales)[:, None]) \
        * s


def csr_pack_indices_ref(indices, stored, n):
    """(K, cap) absolute int32 columns (ascending in each stored prefix)
    -> (offsets (K, cap) int16 = col % 512 with padding zeroed,
    block_counts (K, ceil(n/512)) int16, the stored slots per 512-column
    block) (``repro/kernels/ref.py:183-203``)."""
    K, cap = indices.shape
    nblk = max((n + BLK - 1) // BLK, 1)
    valid = _valid_slots(cap, stored, indices.device)
    idx = indices.to(torch.int64)
    offs = torch.where(valid, idx % BLK, torch.zeros_like(idx))
    blk = torch.where(valid, idx // BLK, torch.full_like(idx, nblk))
    counts = torch.zeros((K, nblk + 1), dtype=torch.int32,
                         device=indices.device)
    counts.scatter_add_(1, blk, torch.ones_like(blk, dtype=torch.int32))
    return offs.to(torch.int16), counts[:, :nblk].to(torch.int16)


def csr_unpack_indices_ref(offsets, block_counts):
    """Absolute int32 columns from the packed ``csr_q`` indices: slot s
    lies in the first block whose cumulative count exceeds s; padding
    slots resolve past the last block and are clamped into it
    (``repro/kernels/ref.py:206-222``)."""
    K, cap = offsets.shape
    nblk = block_counts.shape[1]
    cum = torch.cumsum(block_counts.to(torch.int32), dim=1,
                       dtype=torch.int32)
    slots = torch.arange(cap, dtype=torch.int32,
                         device=offsets.device).expand(K, cap).contiguous()
    blk = torch.clamp(torch.searchsorted(cum, slots, right=True),
                      max=nblk - 1)
    return (blk * BLK + offsets.to(torch.int64)).to(torch.int32)


def staleness_agg_ref(deltas, weights):
    """Paper Eq. 10 inner sum: ``out[n] = sum_k w_k * d[k, n]`` in float32,
    accumulated over k in order (the CUDA kernel's order).
    deltas: (K, N); weights: (K,). Returns (N,)."""
    w = weights.to(torch.float32)
    out = torch.zeros(deltas.shape[1], dtype=torch.float32,
                      device=deltas.device)
    for k in range(deltas.shape[0]):
        out = out + w[k] * deltas[k].to(torch.float32)
    return out


def attention_mask(S, window, device):
    """(S, S) bool, True where query row qp may see key kp: ``kp <= qp``
    and, with a window, ``kp > qp - window``."""
    pos = torch.arange(S, device=device)
    ok = pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= pos[None, :] > (pos[:, None] - window)
    return ok


def _gqa_logits(q, k):
    """q (B, S, Hq, hd), k (B, S, Hkv, hd) -> (B, Hq, S, S) in q's dtype;
    query head h reads KV head h // (Hq / Hkv)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, hd)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k).reshape(B, Hq, S, -1)


def _gqa_values(w, v):
    """w (B, Hq, S, S), v (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    B, Hq, S, _ = w.shape
    Hkv, hd = v.shape[2], v.shape[3]
    wg = w.reshape(B, Hkv, Hq // Hkv, S, -1)
    return torch.einsum("bhgqk,bkhd->bqhgd", wg, v).reshape(B, S, Hq, hd)


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """What the TPU flash kernel computes
    (``repro/kernels/flash_attention.py:25-62``), with GQA read in place:
    q (B, S, Hq, hd), k / v (B, S, Hkv, hd) in bf16 or f32 -> (B, S, Hq, hd)
    in q's dtype. In float32: ``s = (q . k) * (1 / sqrt(hd))``, masked
    (causal, and the window when given) to -1e30, ``p = exp(s - max)``,
    ``out = (p @ v) / max(sum p, 1e-30)``."""
    hd = q.shape[-1]
    s = _gqa_logits(q.float(), k.float()) * (1.0 / math.sqrt(hd))
    if causal:
        ok = attention_mask(q.shape[1], window, q.device)
        s = torch.where(ok, s, torch.full((), -1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                     # (B, Hq, S)
    out = _gqa_values(p, v.float())
    return (out / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
            ).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """Twin of the reference's jnp oracle (``repro/kernels/ref.py:10``):
    the logits come out of the product in the inputs' dtype (rounded
    there) and are divided by sqrt(hd) in float32; the softmax weights are
    cast to v's dtype before the second product. k / v may carry fewer
    heads than q (GQA, head h reads KV head h // (Hq / Hkv))."""
    hd = q.shape[-1]
    logits = _gqa_logits(q, k).float() / math.sqrt(hd)
    if causal:
        ok = attention_mask(q.shape[1], window, q.device)
        logits = torch.where(ok, logits,
                             torch.full((), -1e30, device=q.device))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return _gqa_values(w, v)
