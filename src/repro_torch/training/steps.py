"""Step functions: prefill, inference forward and one greedy decode step.
Port of ``repro/training/steps.py:82-108``. The training steps (``lm_loss``,
``make_train_step``) are not ported: they come with ROADMAP.md queue 3b,
with the FL language-model path and the ``"flash"`` attention."""
from __future__ import annotations

import torch

from repro_torch.models import lm


def make_prefill_step(cfg, cache_len, *, window=None, impl="ref"):
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch, cache_len, window=window,
                          impl=impl)
    return prefill_step


def make_forward_step(cfg, *, window=None, impl="ref"):
    """Inference forward (prefill compute; last-token logits only)."""
    def forward_step(params, batch):
        logits, _, _ = lm.forward(cfg, params, batch, window=window,
                                  impl=impl, head_mode="last")
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
