"""Dense layers of the language models: RMSNorm, RoPE, GQA attention (with
the sliding window, and one-token decode against a KV cache) and the
SwiGLU / GELU MLP. Port of the dense subset of ``repro/models/layers.py``.

Convention (the reference's): every layer is a pair of functions
  ``init_<layer>(cfg, gen) -> params``  (dict of tensors in the param
  dtype, drawn from the ``torch.Generator`` ``gen`` on its device)
  ``<layer>(cfg, params, x, ...) -> y``  (computed in ``cfg.dtype``)
Weights are cast to the compute dtype where they are used, as the
reference casts them; a weight already in that dtype is used as it is.

Attention takes ``impl="ref"`` (the reference's ``_sdpa``, plain
PyTorch), ``impl="pallas"``, the reference's name for its flash kernel,
which here launches the port's CUDA ``flash_attention`` on the card
(``kernels/ops.py``), or ``impl="flash"``, the reference's training
attention ``flash_attention_xla``: blockwise plain code under
rematerialisation, differentiated by autograd as the reference's is by
autodiff. MLA, MoE, mamba, xLSTM and cross-attention are not ported: they
come with ROADMAP.md queue 3b.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

LATER = "ROADMAP.md 'Still to port' queue 3b"
IMPLS = ("ref", "pallas", "flash")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdtype(cfg):
    return DTYPES[cfg.dtype]


def pdtype(cfg):
    return DTYPES[cfg.param_dtype]


def gen_device(gen):
    """``gen``'s device; no generator (``gen=None``) builds on the meta
    device: shapes and dtypes only, for a model's template."""
    return torch.device("meta") if gen is None else gen.device


def _dense_init(gen, shape, dtype, scale=None):
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, device=gen_device(gen)) * scale
            ).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(cfg, gen, dim=None):
    dim = dim or cfg.d_model
    return {"scale": torch.ones((dim,), dtype=pdtype(cfg),
                                device=gen_device(gen))}


def rmsnorm(cfg, params, x):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + cfg.norm_eps)
    return (x * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(cfg, dim, device=None):
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (cfg.rope_theta ** exps)          # (half,)


def apply_rope(cfg, x, positions, dim=None):
    """x: (..., S, H, hd) with positions broadcastable to (..., S)."""
    dim = dim or x.shape[-1]
    inv = rope_freqs(cfg, dim, x.device)
    angles = positions[..., None].float() * inv     # (..., S, half)
    sin = torch.sin(angles)[..., None, :]           # broadcast over heads
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def init_attention(cfg, gen):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    pdt, dev = pdtype(cfg), gen_device(gen)
    p = {
        "wq": _dense_init(gen, (d, nq * hd), pdt),
        "wk": _dense_init(gen, (d, nkv * hd), pdt),
        "wv": _dense_init(gen, (d, nkv * hd), pdt),
        "wo": _dense_init(gen, (nq * hd, d), pdt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq * hd,), dtype=pdt, device=dev)
        p["bk"] = torch.zeros((nkv * hd,), dtype=pdt, device=dev)
        p["bv"] = torch.zeros((nkv * hd,), dtype=pdt, device=dev)
    return p


def _causal_mask(q_pos, k_pos, window):
    """(..., Sq, Sk) boolean mask. True = attend."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,Hq,hd), k/v: (B,Sk,Hkv,hd_v) with Hq = G*Hkv. The logits
    come out of the product in the inputs' dtype, as in the reference."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    hd_v = v.shape[3]
    q = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, Sq, Hq, hd_v)


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


# ---------------------------------------------------------------------------
# Flash attention in plain code (the reference's ``impl="flash"``)
# ---------------------------------------------------------------------------
# default tile sizes. The reference's ``constrain`` switch (sharding
# constraints for a device mesh) is not taken here.
FLASH_BLOCKS = {"qblk": 512, "kblk": 512, "tile_bf16": False}


def flash_attention_xla(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                        qblk=None, kblk=None):
    """Blockwise attention by online softmax over (qblk x kblk) tiles, the
    reference's ``flash_attention_xla``. While autograd records, the call
    runs under ``checkpoint`` as the reference's runs under
    ``jax.checkpoint``: only q, k, v and the positions stay alive for the
    backward, which recomputes the tiles."""
    f = functools.partial(_flash_attention_xla_impl, causal=causal,
                          window=window, qblk=qblk or FLASH_BLOCKS["qblk"],
                          kblk=kblk or FLASH_BLOCKS["kblk"],
                          tile_bf16=FLASH_BLOCKS["tile_bf16"])
    if torch.is_grad_enabled():
        return checkpoint(f, q, k, v, q_pos, k_pos, use_reentrant=False)
    return f(q, k, v, q_pos, k_pos)


def _flash_attention_xla_impl(q, k, v, q_pos, k_pos, *, causal, window,
                              qblk, kblk, tile_bf16):
    """q: (B,Sq,Hq,hd); k/v: (B,Sk,Hkv,hd); positions (B,Sq) / (B,Sk), read
    only when a length is not a multiple of its block (``_sdpa`` then
    takes the whole call); the tiles take their positions from the block
    counters. KV heads are repeated to the full head count. Every tile is
    computed: a fully masked one is wiped by the next ``corr = 0``."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    hdv = v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qblk = min(qblk, Sq)
    kblk = min(kblk, Sk)
    if Sq % qblk or Sk % kblk:
        mask = _causal_mask(q_pos, k_pos, window) if causal else None
        return _sdpa(q, k, v, mask, scale)
    nq, nk = Sq // qblk, Sk // kblk
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qb = q.reshape(B, nq, qblk, Hq, hd).permute(1, 0, 3, 2, 4)  # (nq,B,H,qblk,hd)
    kb = k.reshape(B, nk, kblk, Hq, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, kblk, Hq, hdv).permute(1, 0, 3, 2, 4)
    iq = torch.arange(qblk, dtype=torch.int32, device=q.device)
    ik = torch.arange(kblk, dtype=torch.int32, device=q.device)
    outs = []
    for qidx in range(nq):
        qi = qb[qidx]
        qp = qidx * qblk + iq
        m = torch.full((B, Hq, qblk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hq, qblk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hq, qblk, hdv), dtype=torch.float32,
                          device=q.device)
        for kidx in range(nk):
            ki, vi = kb[kidx], vb[kidx]
            kp = kidx * kblk + ik
            s = torch.einsum("bhqd,bhkd->bhqk", qi, ki).float() * scale
            if causal:
                ok = kp[None, :] <= qp[:, None]          # (qblk, kblk)
                if window is not None:
                    ok &= kp[None, :] > (qp[:, None] - window)
                s = torch.where(ok, s, -1e30)
            if tile_bf16:
                s = s.to(torch.bfloat16).float()
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vi.dtype), vi).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, Sq, Hq, hdv)


def _project(cfg, params, x, dt):
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def attention(cfg, params, x, positions, *, window=None, causal=True,
              impl="ref"):
    """Full (or sliding-window) causal self-attention. ``impl="pallas"``
    runs the flash kernel (``ops.flash_attention``), which takes the
    positions to be 0..S-1, as the reference's does; ``impl="flash"``
    runs ``flash_attention_xla``."""
    _check_impl(impl)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = cdtype(cfg)
    q, k, v = _project(cfg, params, x, dt)
    q = apply_rope(cfg, q.reshape(B, S, nq, hd), positions)
    k = apply_rope(cfg, k.reshape(B, S, nkv, hd), positions)
    v = v.reshape(B, S, nkv, hd)
    if impl == "pallas" and causal:
        out = ops.flash_attention(q, k, v, window=window)
    elif impl == "flash" and causal:
        out = flash_attention_xla(q, k, v, positions, positions,
                                  window=window)
    else:
        mask = _causal_mask(positions, positions, window) if causal else None
        out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    return out.reshape(B, S, nq * hd) @ params["wo"].to(dt)


def attention_decode(cfg, params, x, cache_k, cache_v, index, *,
                     ring=False):
    """One-token decode. x: (B, d). cache_k/v: (B, S, Hkv, hd); ``index``
    the token's position (an int). The new k / v are written into the
    caches in place (the reference returns updated copies), at ``index``,
    or at ``index % S`` with ``ring`` (a sliding-window ring buffer, fully
    valid once it has wrapped). Returns (out (B, d), cache_k, cache_v)."""
    B, _ = x.shape
    S = cache_k.shape[1]
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = cdtype(cfg)
    q, k, v = _project(cfg, params, x, dt)
    pos = torch.full((B, 1), index, dtype=torch.long, device=x.device)
    q = apply_rope(cfg, q.reshape(B, 1, nq, hd), pos)
    k = apply_rope(cfg, k.reshape(B, 1, nkv, hd), pos)
    v = v.reshape(B, 1, nkv, hd)

    slot = index % S if ring else index
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    kpos = torch.arange(S, device=x.device)
    valid = (kpos <= slot) | (index >= S) if ring else kpos <= index
    mask = valid.expand(B, 1, S)
    out = _sdpa(q, cache_k.to(dt), cache_v.to(dt), mask, 1.0 / math.sqrt(hd))
    out = out.reshape(B, nq * hd) @ params["wo"].to(dt)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------
def init_mlp(cfg, gen, d_ff=None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {
        "w_up": _dense_init(gen, (d, ff), pdtype(cfg)),
        "w_down": _dense_init(gen, (ff, d), pdtype(cfg)),
    }
    if cfg.gated_mlp:
        p["w_gate"] = _dense_init(gen, (d, ff), pdtype(cfg))
    return p


def mlp(cfg, params, x):
    dt = cdtype(cfg)
    up = x @ params["w_up"].to(dt)
    if cfg.gated_mlp:
        gate = x @ params["w_gate"].to(dt)
        # jax.nn.silu as the reference computes it: x * (1 / (1 + exp(-x))),
        # each op rounded to the compute dtype
        up = gate * (1.0 / (1.0 + torch.exp(-gate))) * up
    else:
        up = F.gelu(up, approximate="tanh")        # jax.nn.gelu's default
    return up @ params["w_down"].to(dt)
