"""Full model assembly: embeddings, the stack of layers, heads, and the
prefill and decode of serving. Port of ``repro/models/lm.py`` for dense
decoders (every layer an attention block with an MLP).

The parameter tree is the reference's: ``{"embed", "final_norm",
["lm_head"], "prefix": [block, ...], "scan": {"pos_j": stacked}}``, where
the layers that repeat with period ``period`` are stacked along a leading
axis of ``reps`` (``scan_plan``), so ``weights.tree_from_numpy`` carries
the reference's parameters over leaf by leaf. The reference scans the
stack with ``lax.scan``; here it is a Python loop over ``reps``, each
repetition under ``checkpoint`` (``remat``) as the reference's scan body
is under ``jax.checkpoint``. Encoder frames (whisper) and vision patches
(pixtral) are not ported: they come with ROADMAP.md queue 3b.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as B
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# scan planning
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def scan_plan(cfg):
    """Return (prefix_len, period, reps) maximizing stacked repetitions."""
    sigs = cfg.layer_pattern()
    n = len(sigs)
    best = (0, 1, 0)  # prefix, period, reps
    best_score = (-1, 0, 0)
    for prefix in range(n + 1):
        rem = n - prefix
        if rem == 0:
            continue
        for period in range(1, rem + 1):
            if rem % period:
                continue
            if all(sigs[i] == sigs[i + period]
                   for i in range(prefix, n - period)):
                reps = rem // period
                score = (reps, -prefix, -period)
                if score > best_score:
                    best_score = score
                    best = (prefix, period, reps)
                break  # smallest valid period for this prefix is optimal
    prefix, period, reps = best
    if reps < 2:  # not worth stacking; unroll everything
        return n, 1, 0
    return prefix, period, reps


def _check_model(cfg, batch=None):
    what = None
    if cfg.is_encoder_decoder or (batch is not None and "frames" in batch):
        what = "encoder frames (encoder-decoder models)"
    elif cfg.num_vision_patches or (batch is not None and "patches" in batch):
        what = "vision patches"
    if what:
        raise NotImplementedError(f"{what} of {cfg.name} are not ported; "
                                  f"they come with {L.LATER}")


def _stack(trees):
    """A list of same-shaped trees -> one tree, leaves stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, r):
    """Row ``r`` of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg, gen):
    """Random parameters from the ``torch.Generator`` ``gen``, on its
    device, with the reference's shapes, scales and dtypes (not its
    numbers: its PRNG is JAX's). ``gen=None``: the same tree on the meta
    device (``param_template``)."""
    _check_model(cfg)
    sigs = cfg.layer_pattern()
    prefix_len, period, reps = scan_plan(cfg)
    d = cfg.d_model
    params = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen,
                              device=L.gen_device(gen)) * 0.02
                  ).to(L.pdtype(cfg)),
        "final_norm": L.init_rmsnorm(cfg, gen),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(gen, (d, cfg.vocab_size),
                                          L.pdtype(cfg))
    params["prefix"] = [B.init_block(cfg, gen, sigs[i])
                        for i in range(prefix_len)]
    if reps:
        params["scan"] = {
            f"pos_{j}": _stack([B.init_block(cfg, gen, sigs[prefix_len + j])
                                for _ in range(reps)])
            for j in range(period)}
    return params


@functools.lru_cache(maxsize=None)
def param_template(cfg):
    """The parameter tree of ``cfg`` as meta tensors: the shapes and
    dtypes, no memory (the reference's ``jax.eval_shape`` of
    ``init_params``)."""
    return init_params(cfg, None)


def compute_params(cfg, params):
    """``params`` with every weight that the layers cast to ``cfg.dtype``
    cast once (the norms' scales, read in float32, stay as they are). The
    layers then use them as they are: the same bits as casting at each
    use, which the reference does."""
    dt = L.cdtype(cfg)

    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree if key == "scale" else tree.to(dt)
    return cast(params)


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(cfg, params, batch, *, window=None, impl="ref", remat=True,
            collect_cache=False, head_mode="full"):
    """batch: {"tokens": (B,S) integer}. Returns (logits float32, aux,
    caches|None). ``head_mode``: "full" logits (B,S,V) or "last" logits
    (B,V). ``impl``: "ref", "pallas" (the CUDA flash kernel on the card)
    or "flash" (``layers.flash_attention_xla``). ``remat``: while autograd
    records, each repetition of the stacked layers keeps only its input
    for the backward and recomputes the rest there; the prefix layers are
    not rematerialised, as in the reference."""
    _check_model(cfg, batch)
    sigs = cfg.layer_pattern()
    prefix_len, period, reps = scan_plan(cfg)
    dt = L.cdtype(cfg)

    tokens = batch["tokens"]
    x = params["embed"].to(dt)[tokens]
    Bsz, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(Bsz, S)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {"prefix": [], "scan": {}} if collect_cache else None
    for i in range(prefix_len):
        x, a, c = B.apply_block(cfg, params["prefix"][i], sigs[i], x,
                                positions, window=window, impl=impl,
                                collect_cache=collect_cache)
        aux = aux + a
        if collect_cache:
            caches["prefix"].append(c)

    def body(x, aux, per_rep):
        reps_cache = {}
        for j in range(period):
            x, a, c = B.apply_block(cfg, per_rep[f"pos_{j}"],
                                    sigs[prefix_len + j], x, positions,
                                    window=window, impl=impl,
                                    collect_cache=collect_cache)
            aux = aux + a
            reps_cache[f"pos_{j}"] = c
        return x, aux, reps_cache

    per_pos = {f"pos_{j}": [] for j in range(period if reps else 0)}
    for r in range(reps):
        per_rep = _index(params["scan"], r)
        if remat and torch.is_grad_enabled():
            x, aux, reps_cache = checkpoint(body, x, aux, per_rep,
                                            use_reentrant=False)
        else:
            x, aux, reps_cache = body(x, aux, per_rep)
        if collect_cache:
            for name, c in reps_cache.items():
                per_pos[name].append(c)
    if collect_cache:
        caches["scan"] = {k: _stack(v) for k, v in per_pos.items() if v}

    x = L.rmsnorm(cfg, params["final_norm"], x)
    if head_mode == "last":
        x = x[:, -1]
    logits = (x @ _head(cfg, params).to(dt)).float()
    return logits, aux, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch_size, cache_len, *, dtype=None, device=None):
    """Zeroed decode cache for the whole model (prefix list + stacks)."""
    _check_model(cfg)
    sigs = cfg.layer_pattern()
    prefix_len, period, reps = scan_plan(cfg)
    cache = {
        "prefix": [B.init_block_cache(cfg, sigs[i], batch_size, cache_len,
                                      dtype=dtype, device=device)
                   for i in range(prefix_len)],
        "scan": {},
    }
    for j in range(period if reps else 0):
        one = B.init_block_cache(cfg, sigs[prefix_len + j], batch_size,
                                 cache_len, dtype=dtype, device=device)
        cache["scan"][f"pos_{j}"] = {
            k: t.new_zeros((reps,) + t.shape) for k, t in one.items()}
    return cache


def decode_step(cfg, params, token, cache, index, *, ring=False):
    """token: (B,) integer; index: the position (an int). -> (logits (B,V),
    cache). The cache's tensors are updated in place and returned."""
    sigs = cfg.layer_pattern()
    prefix_len, period, reps = scan_plan(cfg)
    dt = L.cdtype(cfg)

    x = params["embed"].to(dt)[token]
    new_prefix = []
    for i in range(prefix_len):
        x, c = B.apply_block_decode(cfg, params["prefix"][i], sigs[i], x,
                                    cache["prefix"][i], index, ring=ring)
        new_prefix.append(c)
    for r in range(reps):
        per_rep = _index(params["scan"], r)
        per_cache = _index(cache["scan"], r)      # views: written in place
        for j in range(period):
            x, _ = B.apply_block_decode(cfg, per_rep[f"pos_{j}"],
                                        sigs[prefix_len + j], x,
                                        per_cache[f"pos_{j}"], index,
                                        ring=ring)

    x = L.rmsnorm(cfg, params["final_norm"], x[:, None, :])[:, 0]
    logits = (x @ _head(cfg, params).to(dt)).float()
    return logits, {"prefix": new_prefix, "scan": cache["scan"]}


def prefill(cfg, params, batch, cache_len, *, window=None, impl="ref"):
    """Run the prompt and build a decode cache. Returns (last_logits (B,V),
    cache), the k / v caches padded with zeros to ``cache_len`` along the
    sequence. Only the last position's logits are computed (the reference
    computes all (B, S, V) and keeps the last row)."""
    last, _, caches = forward(cfg, params, batch, window=window, impl=impl,
                              collect_cache=True, head_mode="last")

    def pad_seq(t, axis):
        # t: (..., S, Hkv, hd), padded along ``axis`` (the sequence)
        if t.shape[axis] >= cache_len:
            return t
        pad = [0, 0] * (t.dim() - 1 - axis) + [0, cache_len - t.shape[axis]]
        return F.pad(t, pad)

    cache = {
        "prefix": [{k: pad_seq(v, 1) for k, v in c.items()}
                   for c in caches["prefix"]],
        "scan": {name: {k: pad_seq(v, 2) for k, v in c.items()}
                 for name, c in caches["scan"].items()},
    }
    return last, cache
