"""Client-side unsupervised training via pseudo-labeling (Eq. 5) and the
server-side supervised step (Eq. 6), for the paper's CNN. Port of
``repro/core/pseudo_label.py``.

An epoch pads the data to a multiple of ``batch_size`` with zero rows and
a validity mask (``pseudo_label.py:74-83, 221-233``), and takes one Adam
step per batch; the reference's ``scan`` over batches is a Python loop.
Dropout keep-masks arrive precomputed, one (nb, B, hidden) block per
epoch (``models.cnn.dropout_masks``), or None for no dropout. Each factory
returns a ``run`` function; the device is the parameters'.

The batched engine's factories take a (K, N) stack of flat client models
and step all K clients at once per batch index: one stacked forward and
one autograd pass over the sum of the K per-client losses (the clients
are independent, so the (K, N) gradient is each client's own), and a
per-row Adam in which a batch that holds only padding is a true no-op.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse_comm import (flatten_stacked, flatten_tree,
                                          unflatten_like, unflatten_stacked)
from repro_torch.kernels import ops as kops
from repro_torch.models.cnn import (cnn_forward, cnn_forward_stacked,
                                    cnn_template)
from repro_torch.optimizer import adam_init_rows, adam_update, \
    adam_update_rows


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


def _batches(nb, batch_size, tensors, masks):
    """Per batch: the tensors' slices, then that batch's dropout mask."""
    return [tuple(t[b * batch_size:(b + 1) * batch_size] for t in tensors)
            + (None if masks is None else masks[b],) for b in range(nb)]


def _leaves(params):
    """Detached views of ``params`` that autograd treats as leaves: the
    gradient of each comes back on its own, and a flat model's gradient
    is one concatenation of them, not a sum of full-size gradients of
    every slice."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _grads(loss, params):
    names = sorted(params)
    return dict(zip(names, torch.autograd.grad(loss, [params[k]
                                                      for k in names])))


def _epoch(params, opt, batches, loss_fn, lr, l1):
    """One Adam step per batch of ``batches``; returns (params, opt, mean
    batch loss as a device scalar)."""
    losses = []
    for batch in batches:
        p = _leaves(params)
        loss = loss_fn(p, *batch)
        params, opt = adam_update(_grads(loss, p), opt, params, lr=lr, l1=l1)
        losses.append(loss.detach())
    return params, opt, torch.stack(losses).mean()


def _pseudo_loss(logits, threshold, valid):
    """Eq. 5 over the last-but-one axis: mean of the masked per-row losses
    over the valid rows, ``max(sum(valid), 1)`` as the normalizer."""
    loss, _ = kops.masked_pseudo_ce(logits.reshape(-1, logits.shape[-1]),
                                    threshold)
    loss = loss.reshape(valid.shape)
    return torch.sum(loss * valid, dim=-1) / \
        torch.clamp(torch.sum(valid, dim=-1), min=1.0)


def _supervised_loss(logits, y, valid):
    """Eq. 6: cross entropy over the valid rows."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, y[:, None])[:, 0]
    return torch.sum(ce * valid) / torch.clamp(torch.sum(valid), min=1.0)


def make_client_epoch(cfg, *, batch_size=100, threshold=0.95, l1=0.0):
    """One unsupervised epoch (E=1 per paper default) over a client's data:
    ``run(params, opt, x_np, lr, masks) -> (params, opt, mean loss)`` with
    ``masks`` (nb, B, hidden) or None."""

    def loss_fn(p, xi, vi, mask):
        return _pseudo_loss(cnn_forward(cfg, p, xi, mask=mask), threshold,
                            vi)

    def run(params, opt, x_np, lr, masks):
        device = next(iter(params.values())).device
        nb, (x, valid) = _padded(x_np, batch_size, device)
        return _epoch(params, opt, _batches(nb, batch_size, (x, valid), masks),
                      loss_fn, lr, l1)

    return run


def make_server_epoch(cfg, *, batch_size=100, l1=0.0):
    """One supervised epoch on the server's labeled data:
    ``run(params, opt, x_np, y_np, lr, masks) -> (params, opt, mean
    loss)``."""

    def loss_fn(p, xi, yi, vi, mask):
        return _supervised_loss(cnn_forward(cfg, p, xi, mask=mask), yi, vi)

    def run(params, opt, x_np, y_np, lr, masks):
        device = next(iter(params.values())).device
        nb, (x, valid, y) = _padded(x_np, batch_size, device, y_np)
        return _epoch(params, opt,
                      _batches(nb, batch_size, (x, y, valid), masks),
                      loss_fn, lr, l1)

    return run


def make_server_epoch_flat(cfg, *, batch_size=100, l1=0.0):
    """Flat-state twin of ``make_server_epoch`` for the batched engine
    (``pseudo_label.py:238-294``): ``run(flat, opt, x_np, y_np, lr, masks)
    -> (flat, opt, mean loss)`` with the model an (N,) vector and ``opt``
    the one-row Adam state of ``adam_init_rows(flat[None])``. The forward
    reads views of the flat vector; their gradients, concatenated, are the
    flat gradient."""
    template = cnn_template(cfg)

    def run(flat, opt, x_np, y_np, lr, masks):
        nb, (x, valid, y) = _padded(x_np, batch_size, flat.device, y_np)
        rate = torch.full((1,), lr, dtype=torch.float32, device=flat.device)
        live = torch.ones(1, dtype=torch.bool, device=flat.device)
        losses = []
        for xi, yi, vi, mask in _batches(nb, batch_size, (x, y, valid),
                                         masks):
            p = _leaves(unflatten_like(flat, template))
            loss = _supervised_loss(cnn_forward(cfg, p, xi, mask=mask), yi,
                                    vi)
            g = flatten_tree(_grads(loss, p))
            rows, opt = adam_update_rows(g[None], opt, flat[None], lr=rate,
                                         live=live, l1=l1)
            flat = rows[0]
            losses.append(loss.detach())
        return flat, opt, torch.stack(losses).mean()

    return run


def make_batched_client_epoch(cfg, *, batch_size=100, threshold=0.95, l1=0.0,
                              epochs=1):
    """All K participants' pseudo-label epochs at once
    (``pseudo_label.py:94-191``): ``run(base_flat, x, valid, lrs, masks) ->
    (trained (K, N), per-client mean loss (K,))`` with x (K, nb*B, F) and
    valid (K, nb*B) the participants' data padded to a common batch count,
    lrs (K,) their rates and masks (K, epochs, nb, B, hidden) or None.

    Each batch index is one stacked step: a (K, B) forward, the Eq. 5 loss
    over all K*B rows in one ``masked_pseudo_ce`` launch, one autograd pass
    and the per-row Adam, which leaves a client whose batch holds only
    padding untouched. Every client starts from a zeroed Adam state that
    persists across its epochs. Batch indices where no client has data
    are skipped."""
    template = cnn_template(cfg)

    def run(base_flat, x, valid, lrs, masks):
        K = base_flat.shape[0]
        nb = x.shape[1] // batch_size
        xb = x.reshape(K, nb, batch_size, -1)
        vb = valid.reshape(K, nb, batch_size)
        live = torch.sum(vb, dim=2) > 0                      # (K, nb)
        steps = [b for b, a in enumerate(live.any(dim=0).tolist()) if a]
        rate = torch.as_tensor(np.asarray(lrs, np.float32),
                               device=base_flat.device)
        flat, opt = base_flat, adam_init_rows(base_flat)
        loss_sum = torch.zeros(K, device=base_flat.device)
        for e in range(epochs):
            for b in steps:
                p = _leaves(unflatten_stacked(flat, template))
                logits = cnn_forward_stacked(
                    cfg, p, xb[:, b],
                    mask=None if masks is None else masks[:, e, b])
                per = _pseudo_loss(logits, threshold, vb[:, b])
                g = flatten_stacked(_grads(per.sum(), p))
                flat, opt = adam_update_rows(g, opt, flat, lr=rate,
                                             live=live[:, b], l1=l1)
                loss_sum = loss_sum + per.detach()
        n_live = torch.clamp(live.sum(dim=1).to(torch.float32) * epochs,
                             min=1.0)
        return flat, loss_sum / n_live

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


def class_histogram_batch(cfg, *, batch_size=100):
    """Batched ``class_histogram`` (``pseudo_label.py:316-359``):
    ``hist(flat (K, N), x (K, nb*B, F), valid (K, nb*B)) -> (K, C)``.
    Padding rows are left out of the counts and of the denominator, so row
    k is the sequential histogram of client k's own data. One stacked
    forward per batch index that holds any data."""
    template = cnn_template(cfg)
    C = cfg.num_classes

    @torch.no_grad()
    def hist(flat, x, valid):
        K = flat.shape[0]
        params = unflatten_stacked(flat, template)
        xb = x.reshape(K, -1, batch_size, x.shape[-1])
        vb = valid.reshape(K, -1, batch_size)
        acc = torch.zeros((K, C), dtype=torch.float32, device=flat.device)
        for b, any_live in enumerate((vb.sum(dim=2) > 0).any(dim=0).tolist()):
            if any_live:
                pred = torch.argmax(cnn_forward_stacked(cfg, params, xb[:, b]),
                                    dim=-1)
                onehot = torch.nn.functional.one_hot(pred, C)
                acc += torch.sum(onehot * vb[:, b, :, None], dim=1)
        return acc / torch.clamp(valid.sum(dim=1), min=1.0)[:, None]

    return hist
