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


def tree_from_numpy(tree, device):
    """A nested tree of dicts and lists of arrays (a language model's
    parameters, e.g. the reference's ``init_params`` exported leaf by leaf
    with ``np.asarray``) -> the same tree of tensors on ``device``, each
    leaf keeping its dtype (float32 parameters stay float32)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def tree_to_numpy(tree):
    """The inverse of ``tree_from_numpy``: tensors -> host numpy arrays of
    their dtype."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return tree.detach().to("cpu").numpy()
