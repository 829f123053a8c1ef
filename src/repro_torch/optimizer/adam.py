"""Adam with the paper's L1 regularisation (§IV-F), on parameter trees
(the CNN's flat dict, or a language model's nested dicts and lists).

Port of ``repro/optimizer/adam.py:16-49``, written out rather than taken
from ``torch.optim.Adam``: the L1 sign subgradient joins the gradient,
the bias correction is computed in float32 from an int32 step count, and
eps is added after ``sqrt(vhat)``. Updates are functional (new tensors),
so a base model that seeded a client is never written through.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import from_leaves, tree_map


def adam_init(params):
    lv = tree_leaves(params)
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "t": torch.zeros((), dtype=torch.int32, device=lv[0].device),
    }


@torch.no_grad()
def adam_update(grads, opt_state, params, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                l1=0.0):
    t = opt_state["t"] + 1
    tf = t.to(torch.float32)
    c1 = 1 - b1 ** tf
    c2 = 1 - b2 ** tf

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.to(torch.float32)
        if l1:
            g = g + l1 * torch.sign(p)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        new_p.append(p - lr * step)
        new_m.append(m)
        new_v.append(v)
    return from_leaves(params, new_p), {"m": from_leaves(params, new_m),
                                        "v": from_leaves(params, new_v),
                                        "t": t}


def adam_init_rows(flat):
    """Zeroed Adam state for a (K, N) stack of flat parameter rows, one
    step count per row."""
    return {"m": torch.zeros_like(flat), "v": torch.zeros_like(flat),
            "t": torch.zeros(flat.shape[0], dtype=torch.int32,
                             device=flat.device)}


@torch.no_grad()
def adam_update_rows(grad, opt_state, flat, *, lr, live, b1=0.9, b2=0.999,
                     eps=1e-8, l1=0.0):
    """``adam_update`` on (K, N) flat rows, each row its own optimizer: the
    reference's per-client Adam under its client-axis vmap
    (``repro/core/pseudo_label.py:132-156``). ``lr``: (K,) float32 per-row
    rates; ``live``: (K,) bool. A row that is not live (its batch holds
    only padding) keeps its parameters, moments and step count exactly, so
    a client padded to more batches takes only its own steps."""
    t = opt_state["t"] + live.to(torch.int32)
    tf = t.to(torch.float32)[:, None]
    c1 = 1 - b1 ** tf
    c2 = 1 - b2 ** tf
    g = grad.to(torch.float32)
    if l1:
        g = g + l1 * torch.sign(flat)
    m = b1 * opt_state["m"] + (1 - b1) * g
    v = b2 * opt_state["v"] + (1 - b2) * g * g
    step = (m / c1) / (torch.sqrt(v / c2) + eps)
    new = flat - lr.to(torch.float32)[:, None] * step
    keep = live[:, None]
    return torch.where(keep, new, flat), {
        "m": torch.where(keep, m, opt_state["m"]),
        "v": torch.where(keep, v, opt_state["v"]), "t": t}
