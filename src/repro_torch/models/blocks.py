"""Residual blocks: init / forward / decode, dispatched on the layer signature
``(kind, is_moe)`` from ``ModelConfig.layer_pattern()``. Port of
``repro/models/blocks.py`` for the dense attention block:

  ATTN : x + attn(ln1(x));  x + mlp(ln2(x))

The other signatures of the reference (MLA, MoE, mamba, mLSTM / sLSTM)
raise ``NotImplementedError``: they come with ROADMAP.md queue 3b, as
does cross-attention (encoder-decoder models, refused in ``lm.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN
from repro_torch.models import layers as L


def _check_sig(cfg, sig):
    kind, is_moe = sig
    what = None
    if kind != ATTN:
        what = f"{kind} blocks"
    elif is_moe:
        what = "MoE layers (and moe_sort)"
    elif cfg.mla:
        what = "MLA attention"
    if what:
        raise NotImplementedError(f"{what} of {cfg.name} are not ported; "
                                  f"they come with {L.LATER}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_block(cfg, gen, sig):
    _check_sig(cfg, sig)
    p = {"ln1": L.init_rmsnorm(cfg, gen), "attn": L.init_attention(cfg, gen)}
    if cfg.d_ff:
        p["ln2"] = L.init_rmsnorm(cfg, gen)
        p["mlp"] = L.init_mlp(cfg, gen)
    return p


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------
def apply_block(cfg, params, sig, x, positions, *, window=None, impl="ref",
                collect_cache=False, causal=True):
    """Returns (x, aux_loss, cache_or_None).

    ``collect_cache``: capture this layer's K / V for decode."""
    _check_sig(cfg, sig)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None

    h = L.rmsnorm(cfg, params["ln1"], x)
    a = L.attention(cfg, params["attn"], h, positions, window=window,
                    impl=impl, causal=causal)
    if collect_cache:
        cache = _attn_kv(cfg, params["attn"], h, positions)
    x = x + a
    if "mlp" in params:
        h = L.rmsnorm(cfg, params["ln2"], x)
        x = x + L.mlp(cfg, params["mlp"], h)
    return x, aux, cache


def _attn_kv(cfg, attn_params, h, positions):
    """Recompute (rotated) K / V for cache capture during prefill, as the
    reference does."""
    B, S, _ = h.shape
    dt = h.dtype
    hd = cfg.resolved_head_dim
    k = h @ attn_params["wk"].to(dt)
    v = h @ attn_params["wv"].to(dt)
    if cfg.qkv_bias:
        k = k + attn_params["bk"].to(dt)
        v = v + attn_params["bv"].to(dt)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    return {"k": L.apply_rope(cfg, k, positions), "v": v}


# ---------------------------------------------------------------------------
# decode (single token)
# ---------------------------------------------------------------------------
def apply_block_decode(cfg, params, sig, x, cache, index, *, ring=False):
    """x: (B, d). cache: this block's {"k", "v"}, updated in place.
    Returns (x, cache)."""
    _check_sig(cfg, sig)
    h = L.rmsnorm(cfg, params["ln1"], x[:, None, :])[:, 0]
    a, k, v = L.attention_decode(cfg, params["attn"], h, cache["k"],
                                 cache["v"], index, ring=ring)
    cache = dict(cache, k=k, v=v)
    x = x + a
    if "mlp" in params:
        h = L.rmsnorm(cfg, params["ln2"], x[:, None, :])[:, 0]
        x = x + L.mlp(cfg, params["mlp"], h)
    return x, cache


# ---------------------------------------------------------------------------
# cache allocation
# ---------------------------------------------------------------------------
def init_block_cache(cfg, sig, batch, cache_len, *, dtype=None, device=None):
    """Zero decode state for one block."""
    _check_sig(cfg, sig)
    dt = dtype or L.cdtype(cfg)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
