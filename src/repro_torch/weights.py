"""Carry parameter dicts between numpy and the port.

The reference draws its initial weights and dropout masks from its own
PRNG, which PyTorch cannot reproduce; tests therefore export the
reference's parameters as numpy arrays and start the port from them.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """{name: array} -> {name: float32 tensor on ``device``}."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in tree.items()}


def params_to_numpy(params):
    """{name: tensor} -> {name: float32 numpy array on the host}."""
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in params.items()}
