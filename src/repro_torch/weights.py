"""Carry parameter dicts between numpy and the port.

The reference draws its initial weights and dropout masks from its own
PRNG, which PyTorch cannot reproduce; tests therefore export the
reference's parameters as numpy arrays and start the port from them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device):
    """A tree of arrays ({name: array}, or nested dicts and lists) -> the
    same tree of float32 tensors on ``device``."""
    return tree_map(lambda v: torch.tensor(np.asarray(v), dtype=torch.float32,
                                           device=device), tree)


def params_to_numpy(params):
    """A tree of tensors -> the same tree of float32 numpy arrays on the
    host."""
    return tree_map(lambda v: v.detach().to("cpu", torch.float32).numpy(),
                    params)


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
