"""The paper's anomaly-detection CNN (§V-B), in PyTorch.

Port of ``repro/models/cnn.py``. Two 1D-CNN layers (128/256 filters,
kernel 3, ReLU), flatten, dense 256 (ReLU), dropout 0.1, dense over 9
classes, on 78-dim CIC-IDS-2017 feature vectors (a length-78 sequence with
1 channel). Parameters are a plain dict with the reference's names and
layouts: ``conv*_w`` is ``(K, Cin, Cout)``, not torch's ``(Cout, Cin, K)``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.feds3a_cnn import CNNConfig


def cnn_template(cfg: CNNConfig):
    """One client's parameter tree on the meta device: names, shapes and
    dtypes with no storage (the reference's ``jax.eval_shape``)."""
    f1, f2 = cfg.conv_filters
    K, n, h, c = cfg.conv_kernel, cfg.num_features, cfg.hidden, cfg.num_classes
    shapes = {"conv1_w": (K, 1, f1), "conv1_b": (f1,),
              "conv2_w": (K, f1, f2), "conv2_b": (f2,),
              "dense_w": (n * f2, h), "dense_b": (h,),
              "out_w": (h, c), "out_b": (c,)}
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def init_cnn(cfg: CNNConfig, gen: torch.Generator):
    """He-normal weights (fan-in: every axis but the last) and zero biases,
    drawn from ``gen`` on its device, weights in the order conv1, conv2,
    dense, out. The draws differ from the reference's PRNG; tests that
    compare the two packages start from parameters exported by the
    reference instead."""
    out = {}
    for k, t in cnn_template(cfg).items():
        if k.endswith("_b"):
            out[k] = torch.zeros(t.shape, dtype=torch.float32,
                                 device=gen.device)
        else:
            fan_in = math.prod(t.shape[:-1])
            out[k] = torch.randn(t.shape, generator=gen, device=gen.device) \
                * math.sqrt(2.0 / fan_in)
    return out


def cnn_param_count(cfg: CNNConfig) -> int:
    """Total parameter count of the CNN (shape math only, no allocation)."""
    return sum(t.numel() for t in cnn_template(cfg).values())


def dropout_masks(cfg: CNNConfig, prefix, gen):
    """Keep-masks (*prefix, hidden) bool for the dropout after the dense
    layer, in ONE draw from ``gen`` on its device; None when the config has
    no dropout. An epoch's masks are drawn at once, so a client gets the
    same masks from either engine."""
    if not cfg.dropout > 0:
        return None
    return torch.rand((*prefix, cfg.hidden), generator=gen,
                      device=gen.device) < 1.0 - cfg.dropout


def _im2col(x, k):
    """x: (..., L, Cin) -> (..., L, k * Cin), SAME padding: column i of a
    window is x shifted by ``i - (k - 1) // 2`` (the reference's layout)."""
    lo = (k - 1) // 2
    L = x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, lo, k - 1 - lo))
    cols = torch.stack([xp[..., i:i + L, :] for i in range(k)], dim=-2)
    return cols.reshape(*x.shape[:-1], -1)


def _conv1d(x, w, b):
    """x: (B, L, Cin); w: (K, Cin, Cout). SAME padding, as im2col + matmul
    (the reference's form, so the two sum in the same layout)."""
    return _im2col(x, w.shape[0]) @ w.reshape(-1, w.shape[2]) + b


def _dropout(cfg, h, mask):
    if mask is None or not cfg.dropout > 0:
        return h
    return h * mask / (1.0 - cfg.dropout)


def cnn_forward(cfg: CNNConfig, params, x, *, mask=None):
    """x: (B, num_features) -> logits (B, num_classes). ``mask``: the
    (B, hidden) dropout keep-mask of a training step (``dropout_masks``);
    None evaluates without dropout."""
    h = x[..., None]                                  # (B, 78, 1)
    h = torch.relu(_conv1d(h, params["conv1_w"], params["conv1_b"]))
    h = torch.relu(_conv1d(h, params["conv2_w"], params["conv2_b"]))
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ params["dense_w"] + params["dense_b"])
    return _dropout(cfg, h, mask) @ params["out_w"] + params["out_b"]


def _conv1d_stacked(x, w, b):
    """x: (Kc, B, L, Cin); w: (Kc, K, Cin, Cout); b: (Kc, Cout). One
    batched product per client over its B * L windows."""
    Kc, B, L = x.shape[:3]
    cols = _im2col(x, w.shape[1]).reshape(Kc, B * L, -1)
    out = torch.bmm(cols, w.reshape(Kc, -1, w.shape[3])) + b[:, None, :]
    return out.reshape(Kc, B, L, -1)


def cnn_forward_stacked(cfg: CNNConfig, params, x, *, mask=None):
    """The forward of Kc clients at once. ``params``: every leaf with a
    leading client axis Kc; x: (Kc, B, num_features) -> logits (Kc, B,
    num_classes); ``mask``: (Kc, B, hidden) or None. Row k equals
    ``cnn_forward`` of client k, up to the order of the products' sums."""
    Kc, B = x.shape[:2]
    h = x[..., None]                                  # (Kc, B, 78, 1)
    h = torch.relu(_conv1d_stacked(h, params["conv1_w"], params["conv1_b"]))
    h = torch.relu(_conv1d_stacked(h, params["conv2_w"], params["conv2_b"]))
    h = h.reshape(Kc, B, -1)
    h = torch.relu(torch.bmm(h, params["dense_w"])
                   + params["dense_b"][:, None, :])
    h = _dropout(cfg, h, mask)
    return torch.bmm(h, params["out_w"]) + params["out_b"][:, None, :]
