"""FedS3A aggregation (§IV-D, Eq. 9/10). Port of
``repro/core/aggregation.py:22-70, 295-334``.

The group-based variant (Eq. 10) averages |D|-weighted, g(s)-decayed
client models within each k-means group and arithmetically across
groups; the flat variant (Eq. 9) skips grouping. Weights are float64 on
the host; every weighted sum of models runs through ``staleness_agg``
(the CUDA kernel for models on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse_comm import flatten_tree, unflatten_like
from repro_torch.kernels import ops as kops


def _weighted_sum_trees(trees, weights):
    stack = torch.stack([flatten_tree(t) for t in trees])
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32,
                        device=stack.device)
    return unflatten_like(kops.staleness_agg(stack, w), trees[0])


def combine_weights(data_sizes, stalenesses, g_fn, groups=None):
    """Fold Eq. 9/10 into ONE per-client weight vector.

    Flat (Eq. 9): w_i ∝ |D_i| * g(s_i), normalized as in ``aggregate``.
    Grouped (Eq. 10): w_i = (1/G) * |D_i| g(s_i) / sum_{j in group(i)} |D_j|
    g(s_j). A participant set (or group) whose combined |D|*g(s) mass is
    zero falls back to a uniform weight, so every admitted participant
    contributes.
    """
    data_sizes = np.asarray(data_sizes, dtype=np.float64)
    g = np.array([g_fn(s) for s in stalenesses], dtype=np.float64)
    if groups is None:
        w = data_sizes * g
        if w.sum() <= 0.0:
            return np.full(len(w), 1.0 / max(len(w), 1))
        w = w / max(data_sizes.sum(), 1e-12)
        return w / max(w.sum(), 1e-12)
    groups = np.asarray(groups)
    uniq = np.unique(groups)
    w = np.zeros(len(data_sizes))
    for gidx in uniq:
        sel = groups == gidx
        wg = data_sizes[sel] * g[sel]
        if wg.sum() <= 0.0:
            w[sel] = 1.0 / (sel.sum() * len(uniq))
        else:
            w[sel] = wg / wg.sum() / len(uniq)
    return w


def aggregate(server_params, client_params, *, data_sizes, stalenesses,
              g_fn, f_weight, groups=None):
    """FedS3A global update.

    server_params: supervised model omega_s^{r+1}
    client_params: list of participating clients' models omega_i^{r_i+1}
    data_sizes:    |D_i| per participant
    stalenesses:   r - r_i per participant
    g_fn:          staleness function
    f_weight:      f(r), the dynamic supervised weight
    groups:        optional group index per participant (Eq. 10); None -> Eq. 9
    """
    data_sizes = np.asarray(data_sizes, dtype=np.float64)
    g = np.array([g_fn(s) for s in stalenesses], dtype=np.float64)

    if groups is None:
        w = data_sizes * g
        w = w / max(data_sizes.sum(), 1e-12)
        # Eq. 9: weights |D_i|/|D_c| * g(s_i), normalized over the round
        w = w / max(w.sum(), 1e-12)
        unsup = _weighted_sum_trees(client_params, w)
    else:
        groups = np.asarray(groups)
        uniq = np.unique(groups)
        group_models = []
        for gidx in uniq:
            sel = np.where(groups == gidx)[0]
            wg = data_sizes[sel] * g[sel]
            wg = wg / max(wg.sum(), 1e-12)
            group_models.append(_weighted_sum_trees(
                [client_params[i] for i in sel], wg))
        w = np.full(len(group_models), 1.0 / len(group_models))
        unsup = _weighted_sum_trees(group_models, w)

    return {k: (f_weight * s.to(torch.float32)
                + (1.0 - f_weight) * unsup[k].to(torch.float32)).to(s.dtype)
            for k, s in server_params.items()}
