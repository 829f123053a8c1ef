"""Client-side unsupervised training via pseudo-labeling (Eq. 5) and the
server-side supervised step (Eq. 6), for the paper's CNN. Port of
``repro/core/pseudo_label.py``.

An epoch pads the data to a multiple of ``batch_size`` with zero rows and
a validity mask (``pseudo_label.py:74-83, 221-233``), and takes one Adam
step per batch; the reference's ``scan`` over batches is a Python loop.
Each factory returns a ``run`` function; the device is the parameters'.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.cnn import cnn_forward
from repro_torch.optimizer import adam_update


def _padded(x_np, batch_size, device, y_np=None):
    n = len(x_np)
    nb = max((n + batch_size - 1) // batch_size, 1)
    pad = nb * batch_size - n
    x = np.zeros((nb * batch_size, x_np.shape[1]), np.float32)
    x[:n] = x_np
    valid = np.zeros(nb * batch_size, np.float32)
    valid[:n] = 1.0
    out = [torch.from_numpy(x).to(device), torch.from_numpy(valid).to(device)]
    if y_np is not None:
        y = np.concatenate([y_np, np.zeros(pad, y_np.dtype)]).astype(np.int64)
        out.append(torch.from_numpy(y).to(device))
    return nb, out


def _epoch(params, opt, batches, loss_fn, lr, l1):
    """One Adam step per batch of ``batches``; returns (params, opt, mean
    batch loss as a device scalar)."""
    names = sorted(params)
    losses = []
    for batch in batches:
        p = {k: params[k].detach().requires_grad_(True) for k in names}
        loss = loss_fn(p, *batch)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        params, opt = adam_update(dict(zip(names, grads)), opt, params,
                                  lr=lr, l1=l1)
        losses.append(loss.detach())
    return params, opt, torch.stack(losses).mean()


def make_client_epoch(cfg, *, batch_size=100, threshold=0.95, l1=0.0):
    """One unsupervised epoch (E=1 per paper default) over a client's data:
    ``run(params, opt, x_np, lr, gen) -> (params, opt, mean loss)``."""

    def loss_fn(p, xi, vi, gen):
        logits = cnn_forward(cfg, p, xi, train=True, gen=gen)
        loss, _ = kops.masked_pseudo_ce(logits, threshold)
        return torch.sum(loss * vi) / torch.clamp(torch.sum(vi), min=1.0)

    def run(params, opt, x_np, lr, gen):
        device = next(iter(params.values())).device
        nb, (x, valid) = _padded(x_np, batch_size, device)
        batches = [(x[b * batch_size:(b + 1) * batch_size],
                    valid[b * batch_size:(b + 1) * batch_size], gen)
                   for b in range(nb)]
        return _epoch(params, opt, batches, loss_fn, lr, l1)

    return run


def make_server_epoch(cfg, *, batch_size=100, l1=0.0):
    """One supervised epoch on the server's labeled data:
    ``run(params, opt, x_np, y_np, lr, gen) -> (params, opt, mean loss)``."""

    def loss_fn(p, xi, yi, vi, gen):
        logits = cnn_forward(cfg, p, xi, train=True, gen=gen)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, 1, yi[:, None])[:, 0]
        return torch.sum(ce * vi) / torch.clamp(torch.sum(vi), min=1.0)

    def run(params, opt, x_np, y_np, lr, gen):
        device = next(iter(params.values())).device
        nb, (x, valid, y) = _padded(x_np, batch_size, device, y_np)
        sl = [slice(b * batch_size, (b + 1) * batch_size) for b in range(nb)]
        batches = [(x[s], y[s], valid[s], gen) for s in sl]
        return _epoch(params, opt, batches, loss_fn, lr, l1)

    return run


def predict_fn(cfg):
    @torch.no_grad()
    def predict(params, x):
        return torch.argmax(cnn_forward(cfg, params, x), dim=-1)
    return predict


def class_histogram(cfg):
    """Pseudo-label class distribution of a client (used for grouping: the
    server never sees true client labels)."""
    @torch.no_grad()
    def hist(params, x):
        pred = torch.argmax(cnn_forward(cfg, params, x), dim=-1)
        counts = torch.bincount(pred, minlength=cfg.num_classes)
        return counts.to(torch.float32) / x.shape[0]
    return hist
