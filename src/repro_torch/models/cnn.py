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


def init_cnn(cfg: CNNConfig, gen: torch.Generator):
    """He-normal weights and zero biases, drawn from ``gen`` on its device.
    The draws differ from the reference's PRNG; tests that compare the two
    packages start from parameters exported by the reference instead."""
    f1, f2 = cfg.conv_filters
    K = cfg.conv_kernel
    flat = cfg.num_features * f2
    dev = gen.device

    def he(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * \
            math.sqrt(2.0 / fan_in)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "conv1_w": he((K, 1, f1), K),
        "conv1_b": zeros(f1),
        "conv2_w": he((K, f1, f2), K * f1),
        "conv2_b": zeros(f2),
        "dense_w": he((flat, cfg.hidden), flat),
        "dense_b": zeros(cfg.hidden),
        "out_w": he((cfg.hidden, cfg.num_classes), cfg.hidden),
        "out_b": zeros(cfg.num_classes),
    }


def cnn_param_count(cfg: CNNConfig) -> int:
    """Total parameter count of the CNN (shape math only, no allocation)."""
    f1, f2 = cfg.conv_filters
    K, n, h, c = cfg.conv_kernel, cfg.num_features, cfg.hidden, cfg.num_classes
    return (K * 1 * f1 + f1) + (K * f1 * f2 + f2) + \
        (n * f2 * h + h) + (h * c + c)


def _conv1d(x, w, b):
    """x: (B, L, Cin); w: (K, Cin, Cout). SAME padding, as im2col + matmul
    (the reference's form, so the two sum in the same layout)."""
    K = w.shape[0]
    lo = (K - 1) // 2
    hi = K - 1 - lo
    B, L = x.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, lo, hi))
    cols = torch.stack([xp[:, i:i + L, :] for i in range(K)], dim=2)
    out = cols.reshape(B, L, -1) @ w.reshape(-1, w.shape[2])
    return out + b


def cnn_forward(cfg: CNNConfig, params, x, *, train=False, gen=None):
    """x: (B, num_features) -> logits (B, num_classes). Dropout runs only
    with ``train`` and a generator, drawing its mask from ``gen``."""
    h = x[..., None]                                  # (B, 78, 1)
    h = torch.relu(_conv1d(h, params["conv1_w"], params["conv1_b"]))
    h = torch.relu(_conv1d(h, params["conv2_w"], params["conv2_b"]))
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ params["dense_w"] + params["dense_b"])
    if train and gen is not None and cfg.dropout > 0:
        keep = 1.0 - cfg.dropout
        mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
        h = h * mask / keep
    return h @ params["out_w"] + params["out_b"]
