"""FedS3A aggregation (§IV-D, Eq. 9/10). Port of
``repro/core/aggregation.py:22-70, 106-150, 173-222, 280-363``, with the
baselines' FedAvg (Eq. 3, Eq. 8) and FedAsync blends.

The group-based variant (Eq. 10) averages |D|-weighted, g(s)-decayed
client models within each k-means group and arithmetically across
groups; the flat variant (Eq. 9) skips grouping. Weights are float64 on
the host; every weighted sum of dense models runs through
``staleness_agg`` (the CUDA kernel for models on the card).

The batched engine folds Eq. 9/10 into one weight per client
(``combine_weights``) and blends flat (N,) vectors: ``blend_flat`` from
the uploaded (K, N) stack, ``blend_flat_csr`` / ``blend_flat_csr_q`` from
the bases and the CSR or csr_q payloads, whose weighted scatters add the
rows one after another so that two runs on the card give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse_comm import (csr_columns, flatten_tree,
                                          unflatten_like)
from repro_torch.kernels.ref import csr_unpack_indices_ref
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_map


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

    return tree_map(lambda s, u: (f_weight * s.to(torch.float32)
                                  + (1.0 - f_weight) * u.to(torch.float32)
                                  ).to(s.dtype), server_params, unsup)


def _blend(server_flat, unsup, f_weight):
    """``f * server + (1 - f) * unsup`` with f and 1 - f rounded to
    float32 first, as the reference computes them."""
    fw = np.float32(f_weight)
    return float(fw) * server_flat.to(torch.float32) + \
        float(np.float32(1.0) - fw) * unsup


def blend_flat(server_flat, client_flat, w, f_weight):
    """FedS3A global update from the uploaded (K, N) stack
    (``aggregation.py:106-117``, the kernel form): Eq. 9/10 through the
    combined weights ``w`` (K,), then the f(r) blend. Returns (N,) f32."""
    w = torch.as_tensor(np.asarray(w), dtype=torch.float32,
                        device=client_flat.device)
    return _blend(server_flat, kops.staleness_agg(client_flat, w), f_weight)


def _scatter_rows(indices, stored, values, w, n):
    """``sum_k w_k * values_k`` scattered to the ``csr_columns`` of
    (K, cap) ``indices`` with ``stored`` live slots, in an (n + cap,)
    accumulator cut to (n,). Rows are added in order k = 0..K-1, each
    with its own columns (one row's int64 columns alive at a time); within
    a row every column is distinct (padding goes to spare columns past n),
    so each column takes at most one add per row and the sum is the same
    on every run."""
    out = torch.zeros(n + indices.shape[1], dtype=torch.float32,
                      device=values.device)
    for k in range(indices.shape[0]):
        cols = csr_columns(indices[k:k + 1], stored[k:k + 1], n)[0]
        out.index_add_(0, cols, w[k] * values[k].to(torch.float32))
    return out[:n]


def csr_weighted_scatter(values, indices, stored, w, n):
    """``sum_k w_k * decode(payload_k)`` as an (n,) f32 vector from K CSR
    payload rows (values, indices) (K, cap) with ``stored`` (K,) live
    slots (``aggregation.py:120-133``), without the dense (K, n) decode."""
    return _scatter_rows(indices, stored, values, w.to(torch.float32), n)


def csr_q_weighted_scatter(qvals, qoffs, qcnt, scales, stored, w, n):
    """The csr_q twin of ``csr_weighted_scatter``
    (``aggregation.py:173-203``): columns rebuilt from the int16 offsets
    and block counts, as a receiver does, and the dequantization folded
    into the weight, row k adding ``(w_k * scale_k) * q``."""
    ws = w.to(torch.float32) * scales.to(torch.float32)
    return _scatter_rows(csr_unpack_indices_ref(qoffs, qcnt), stored, qvals,
                         ws, n)


def blend_flat_csr(server_flat, base_flat, values, indices, stored, w,
                   f_weight):
    """FedS3A global update from CSR upload payloads
    (``aggregation.py:136-150``): uploaded_k = base_k + decode(payload_k),
    so the weighted client sum is the dense base sum (``staleness_agg``)
    plus the weighted scatter of the payloads."""
    w = torch.as_tensor(np.asarray(w), dtype=torch.float32,
                        device=base_flat.device)
    unsup = kops.staleness_agg(base_flat, w) + csr_weighted_scatter(
        values, indices, stored, w, server_flat.shape[0])
    return _blend(server_flat, unsup, f_weight)


def blend_flat_csr_q(server_flat, base_flat, qvals, qoffs, qcnt, scales,
                     stored, w, f_weight):
    """FedS3A global update from csr_q upload payloads
    (``aggregation.py:206-222``): uploaded_k = base_k +
    dequant(decode(payload_k)), so the weighted client sum is the dense
    base sum (``staleness_agg``) plus the dequantizing weighted scatter."""
    w = torch.as_tensor(np.asarray(w), dtype=torch.float32,
                        device=base_flat.device)
    unsup = kops.staleness_agg(base_flat, w) + csr_q_weighted_scatter(
        qvals, qoffs, qcnt, scales, stored, w, server_flat.shape[0])
    return _blend(server_flat, unsup, f_weight)


def fedavg(client_params, data_sizes):
    """Eq. 3, plain FedAvg over clients (``aggregation.py:337-341``): the
    |D|-proportional weights normalised in float64 on the host, the sum
    through ``staleness_agg``."""
    w = np.asarray(data_sizes, dtype=np.float64)
    w = w / w.sum()
    return _weighted_sum_trees(client_params, w)


def fedavg_ssl(server_params, client_params, data_sizes, f_weight):
    """Eq. 8, FedAvg with the dynamic supervised weight, the adapted
    baseline (``aggregation.py:344-350``)."""
    unsup = fedavg(client_params, data_sizes)
    return {k: (f_weight * s.to(torch.float32)
                + (1.0 - f_weight) * unsup[k].to(torch.float32)).to(s.dtype)
            for k, s in server_params.items()}


def fedasync_blend(global_params, client_params, *, staleness, alpha=0.9,
                   a=0.5):
    """FedAsync mixing (Xie et al. 2019) with polynomial staleness decay
    (``aggregation.py:353-363``): ``alpha_t = min(alpha (s + 1)^-a, 1)``
    in Python floats, then ``(1 - alpha_t) g + alpha_t c`` elementwise in
    float32."""
    alpha_t = min(alpha * (staleness + 1.0) ** (-a), 1.0)
    return {k: ((1 - alpha_t) * g.to(torch.float32)
                + alpha_t * client_params[k].to(torch.float32)).to(g.dtype)
            for k, g in global_params.items()}
