"""Step functions: training (microbatched gradient accumulation), prefill,
inference forward and one greedy decode step. Port of
``repro/training/steps.py``.

The reference jits these; here they run eagerly, and the gradients come
from autograd. MoE layers are not ported (``moe_impl`` other than
``"einsum"`` raises, naming ROADMAP.md queue 3b). The reference's
``seq_parallel`` is a sharding constraint for a device mesh and is not
taken here.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.layers import LATER
from repro_torch.optimizer.adam import adam_update
from repro_torch.tree import from_leaves, tree_map
from repro_torch.tree import leaves as tree_leaves


def value_and_grad(loss_fn, params):
    """(loss, gradients in leaf order) of ``loss_fn`` at ``params``, each
    leaf a detached view that autograd treats as its own leaf."""
    p = tree_map(lambda v: v.detach().requires_grad_(True), params)
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss, tree_leaves(p), materialize_grads=True)
    return loss.detach(), grads


def _check_moe(moe_impl):
    if moe_impl != "einsum":
        raise NotImplementedError(
            f"moe_impl={moe_impl!r}: MoE layers are not ported; they come "
            f"with {LATER}")


def lm_loss(cfg, params, batch, *, window=None, impl="ref",
            moe_impl="einsum", remat=True):
    """Next-token cross entropy over the text positions, averaged over the
    tokens (or over those ``batch["loss_mask"]`` keeps), plus the router's
    auxiliary loss."""
    _check_moe(moe_impl)
    logits, aux, _ = lm.forward(cfg, params, batch, window=window, impl=impl,
                                remat=remat)
    tokens = batch["tokens"]
    P = logits.shape[1] - tokens.shape[1]      # prepended patches
    logits = logits[:, P:, :]
    pred = logits[:, :-1]
    tgt = tokens[:, 1:].to(torch.int64)
    logp = torch.log_softmax(pred, dim=-1)
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].to(torch.float32)
        ce = torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        ce = torch.mean(ce)
    return ce + cfg.router_aux_loss_coef * aux


def make_train_step(cfg, *, lr=3e-4, num_microbatches=1, window=None,
                    impl="ref", moe_impl="einsum", l1=0.0):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    loss). With ``num_microbatches`` > 1 the batch's rows are split into
    that many consecutive microbatches, one backward each: the float32
    gradients are summed onto zeros in microbatch order and divided by
    their count, as are the losses, so only one microbatch's activations
    are alive at a time. Then one Adam (+ L1) step. A batch whose rows do
    not split evenly raises ``ValueError``, as the reference's reshape
    does."""
    _check_moe(moe_impl)

    def loss_fn(params, mb):
        return lm_loss(cfg, params, mb, window=window, impl=impl,
                       moe_impl=moe_impl)

    def train_step(params, opt_state, batch):
        size = next(iter(batch.values())).shape[0]
        if size % num_microbatches:
            raise ValueError(f"a batch of {size} rows does not split into "
                             f"{num_microbatches} microbatches")
        if num_microbatches == 1:
            loss, grads = value_and_grad(lambda p: loss_fn(p, batch), params)
        else:
            n = num_microbatches
            rows = size // n
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            for i in range(n):
                mb = {k: t[i * rows:(i + 1) * rows] for k, t in batch.items()}
                l, g = value_and_grad(lambda p: loss_fn(p, mb), params)
                for a, b in zip(grads, g):
                    a.add_(b.to(torch.float32))
                del g
                loss = loss + l
            for a in grads:
                a.div_(n)
            loss = loss / n
        params, opt_state = adam_update(from_leaves(params, grads),
                                        opt_state, params, lr=lr, l1=l1)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg, cache_len, *, window=None, impl="ref"):
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, cache_len, window=window,
                          impl=impl)
    return prefill_step


def make_forward_step(cfg, *, window=None, impl="ref"):
    """Inference forward (prefill compute; last-token logits only)."""
    def forward_step(params, batch):
        logits, _, _ = lm.forward(cfg, params, batch, window=window,
                                  impl=impl, remat=False, head_mode="last")
        return logits
    return forward_step


def make_serve_step(cfg, *, ring=False):
    """One decode iteration: greedy-sample the next token, update the
    cache (in place)."""
    def serve_step(params, cache, token, index):
        logits, cache = lm.decode_step(cfg, params, token, cache, index,
                                       ring=ring)
        next_token = torch.argmax(logits, dim=-1).to(token.dtype)
        return next_token, logits, cache
    return serve_step
