"""Model adapters: one contract between the federated engines and a model.
Port of ``repro/core/model_adapter.py:48-341``.

The trainer touches a model only through a small set of closures: init,
tree epochs (the sequential engine), flat stacked epochs (the batched
engine), prediction and pseudo-label histograms. This module packages
that set:

* :class:`CNNAdapter`: the paper's CNN, delegating to the
  ``core.pseudo_label`` factories the trainer called directly before, with
  the same arguments, dropout masks included, so every CNN path keeps its
  bits.
* :class:`LMAdapter`: a language model of the config zoo
  (``configs/base.ModelConfig``, ``models/lm.py``) federated as a
  final-token classifier over its vocabulary. Clients run pseudo-label
  epochs on the last position's logits (Eq. 5 with ``num_classes =
  vocab_size``, through ``ops.masked_pseudo_ce``: on the card the
  vocabulary-wide kernels), the server trains supervised on labeled final
  tokens (Eq. 6). Token rows ride the engines' float32 data plumbing as
  (B, S) rows and are cast to int64 at the embedding. The LM has no
  dropout: it draws no masks, and takes ``masks=None``.

Both adapters expose ``num_classes``, ``param_count()``, ``init(gen)``,
``template``, ``client_epoch``, ``server_epoch``, ``server_epoch_flat``,
``batched_epoch``, ``histogram``, ``histogram_batch``, ``predict``, with
the signatures of the ``core.pseudo_label`` factories.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pseudo_label
from repro_torch.core.pseudo_label import _padded
from repro_torch.core.sparse_comm import unflatten_like
from repro_torch.kernels import ops as kops
from repro_torch.models import lm
from repro_torch.models.cnn import cnn_param_count, cnn_template, init_cnn
from repro_torch.optimizer import adam_init_rows, adam_update, \
    adam_update_rows
from repro_torch.training.steps import value_and_grad as _value_and_grad
from repro_torch.tree import from_leaves
from repro_torch.tree import leaves as tree_leaves

__all__ = ["CNNAdapter", "LMAdapter", "make_adapter"]


def make_adapter(cfg, *, batch_size, threshold, l1, epochs):
    """CNNConfig -> CNNAdapter, ModelConfig (the LM zoo) -> LMAdapter."""
    cls = LMAdapter if isinstance(cfg, ModelConfig) else CNNAdapter
    return cls(cfg, batch_size=batch_size, threshold=threshold, l1=l1,
               epochs=epochs)


class CNNAdapter:
    """The paper's CNN behind the adapter contract: the
    ``core.pseudo_label`` factories with the trainer's arguments."""

    kind = "cnn"

    def __init__(self, cfg, *, batch_size, threshold, l1, epochs):
        self.cfg = cfg
        self.num_classes = cfg.num_classes
        self.client_epoch = pseudo_label.make_client_epoch(
            cfg, batch_size=batch_size, threshold=threshold, l1=l1)
        self.server_epoch = pseudo_label.make_server_epoch(
            cfg, batch_size=batch_size, l1=l1)
        self.server_epoch_flat = pseudo_label.make_server_epoch_flat(
            cfg, batch_size=batch_size, l1=l1)
        self.batched_epoch = pseudo_label.make_batched_client_epoch(
            cfg, batch_size=batch_size, threshold=threshold, l1=l1,
            epochs=epochs)
        self.predict = pseudo_label.predict_fn(cfg)
        self.histogram = pseudo_label.class_histogram(cfg)
        self.histogram_batch = pseudo_label.class_histogram_batch(
            cfg, batch_size=batch_size)

    def param_count(self):
        return cnn_param_count(self.cfg)

    def init(self, gen):
        return init_cnn(self.cfg, gen)

    @property
    def template(self):
        return cnn_template(self.cfg)


# ---------------------------------------------------------------------------
# the LM as a final-token classifier (``model_adapter.py:96-308``)

def _flat_grad(grads):
    return torch.cat([g.reshape(-1).to(torch.float32) for g in grads])


class LMAdapter:
    """A config-zoo LM federated as a final-token classifier (see the
    module docstring). ``num_classes`` is the vocabulary size; data rows
    are float-carried token sequences.

    The reference runs its stacked epoch's clients by ``lax.map`` on the
    CPU and ``vmap`` on an accelerator, the same arithmetic; here
    ``batched_epoch`` takes the K clients one after another on the (K, N)
    stack, so that one client's Adam state (16 bytes a parameter) is alive
    at a time, and skips a client's all-padding batches."""

    kind = "lm"

    def __init__(self, cfg, *, batch_size, threshold, l1, epochs):
        self.cfg = cfg
        self.num_classes = cfg.vocab_size
        self.batch_size = batch_size
        self.threshold = threshold
        self.l1 = l1
        self.epochs = epochs

    def param_count(self):
        return int(self.cfg.param_count())

    def init(self, gen):
        return lm.init_params(self.cfg, gen)

    @property
    def template(self):
        return lm.param_template(self.cfg)

    # -- losses ----------------------------------------------------------
    def _logits(self, params, x):
        """Last-position logits (B, V) of float-carried token rows (B, S),
        float32. Not rematerialised: a client batch's activations are small
        beside the (K, N) stacks, so recomputing them buys no memory, and
        the results are the same bits either way."""
        logits, _, _ = lm.forward(self.cfg, params,
                                  {"tokens": x.to(torch.int64)},
                                  remat=False, head_mode="last")
        return logits

    def _pseudo_loss(self, params, xi, vi):
        """Eq. 5 on the final-token logits, masked over padded rows."""
        loss, _ = kops.masked_pseudo_ce(self._logits(params, xi),
                                        self.threshold)
        return torch.sum(loss * vi) / torch.clamp(torch.sum(vi), min=1.0)

    def _sup_loss(self, params, xi, yi, vi):
        """Eq. 6: supervised cross entropy of the final-token logits."""
        logp = torch.log_softmax(self._logits(params, xi), dim=-1)
        ce = -torch.gather(logp, 1, yi[:, None])[:, 0]
        return torch.sum(ce * vi) / torch.clamp(torch.sum(vi), min=1.0)

    def _batches(self, nb, tensors):
        B = self.batch_size
        return [tuple(t[b * B:(b + 1) * B] for t in tensors)
                for b in range(nb)]

    # -- tree epochs (the sequential engine) -------------------------------
    def _tree_epoch(self, params, opt, batches, loss_fn, lr):
        losses = []
        for batch in batches:
            loss, g = _value_and_grad(lambda p: loss_fn(p, *batch), params)
            params, opt = adam_update(from_leaves(params, g), opt, params,
                                      lr=lr, l1=self.l1)
            losses.append(loss)
        return params, opt, torch.stack(losses).mean()

    def client_epoch(self, params, opt, x_np, lr, masks=None):
        """One pseudo-label epoch: ``(params, opt, mean batch loss)``."""
        assert masks is None, "the LM draws no dropout masks"
        device = tree_leaves(params)[0].device
        nb, (x, valid) = _padded(np.asarray(x_np, np.float32),
                                 self.batch_size, device)
        return self._tree_epoch(params, opt, self._batches(nb, (x, valid)),
                                self._pseudo_loss, lr)

    def server_epoch(self, params, opt, x_np, y_np, lr, masks=None):
        """One supervised epoch on the server's labeled rows."""
        assert masks is None, "the LM draws no dropout masks"
        device = tree_leaves(params)[0].device
        nb, (x, valid, y) = _padded(np.asarray(x_np, np.float32),
                                    self.batch_size, device, y_np)
        return self._tree_epoch(params, opt,
                                self._batches(nb, (x, y, valid)),
                                self._sup_loss, lr)

    # -- flat epochs (the batched engine) ----------------------------------
    def _flat_step(self, flat, opt, rate, loss_fn):
        """One Adam step of the (N,) flat model under ``loss_fn`` with the
        one-row state ``opt``: ``(flat, opt, loss)``."""
        loss, g = _value_and_grad(loss_fn,
                                  unflatten_like(flat, self.template))
        rows, opt = adam_update_rows(
            _flat_grad(g)[None], opt, flat[None], lr=rate,
            live=torch.ones(1, dtype=torch.bool, device=flat.device),
            l1=self.l1)
        return rows[0], opt, loss

    def server_epoch_flat(self, flat, opt, x_np, y_np, lr, masks=None):
        """``server_epoch`` on the (N,) flat model with the one-row Adam
        state of ``adam_init_rows(flat[None])``."""
        assert masks is None, "the LM draws no dropout masks"
        nb, (x, valid, y) = _padded(np.asarray(x_np, np.float32),
                                    self.batch_size, flat.device, y_np)
        rate = torch.full((1,), lr, dtype=torch.float32, device=flat.device)
        losses = []
        for xi, yi, vi in self._batches(nb, (x, y, valid)):
            flat, opt, loss = self._flat_step(
                flat, opt, rate,
                lambda p, xi=xi, yi=yi, vi=vi: self._sup_loss(p, xi, yi, vi))
            losses.append(loss)
        return flat, opt, torch.stack(losses).mean()

    def batched_epoch(self, base_flat, x, valid, lrs, masks=None):
        """The K participants' pseudo-label epochs from their (K, N) bases
        with x (K, nb*B, S), valid (K, nb*B), lrs (K,): ``(trained (K, N),
        per-client mean loss of the last epoch's live steps (K,))``. Each
        client starts from a zeroed Adam state that persists across
        ``epochs``; a batch of only padding takes no step."""
        assert masks is None, "the LM draws no dropout masks"
        K = base_flat.shape[0]
        B = self.batch_size
        nb = x.shape[1] // B
        live = (valid.reshape(K, nb, B).sum(dim=2) > 0).cpu().numpy()
        rates = torch.as_tensor(np.asarray(lrs, np.float32),
                                device=base_flat.device)
        out = torch.empty_like(base_flat)
        losses = torch.zeros(K, dtype=torch.float32, device=base_flat.device)
        for k in range(K):
            flat, opt = base_flat[k], adam_init_rows(base_flat[k][None])
            for _ in range(self.epochs):
                total = torch.zeros((), device=base_flat.device)
                for b in np.flatnonzero(live[k]):
                    xi = x[k, b * B:(b + 1) * B]
                    vi = valid[k, b * B:(b + 1) * B]
                    flat, opt, loss = self._flat_step(
                        flat, opt, rates[k:k + 1],
                        lambda p, xi=xi, vi=vi: self._pseudo_loss(p, xi, vi))
                    total = total + loss
            out[k] = flat
            losses[k] = total / max(int(live[k].sum()), 1)
        return out, losses

    # -- predictions and histograms ----------------------------------------
    @torch.no_grad()
    def predict(self, params, x):
        return torch.argmax(self._logits(params, x), dim=-1)

    @torch.no_grad()
    def histogram(self, params, x):
        """Pseudo-label class distribution (V,) of one client's rows."""
        pred = torch.argmax(self._logits(params, x), dim=-1)
        counts = torch.bincount(pred, minlength=self.num_classes)
        return counts.to(torch.float32) / x.shape[0]

    @torch.no_grad()
    def histogram_batch(self, flat, x, valid):
        """``histogram`` of each of the K (N,) rows of ``flat`` over its
        own valid rows of x (K, nb*B, S): (K, V); batches of only padding
        are skipped, padding rows left out of counts and denominator."""
        K = flat.shape[0]
        B = self.batch_size
        nb = x.shape[1] // B
        live = (valid.reshape(K, nb, B).sum(dim=2) > 0).cpu().numpy()
        acc = torch.zeros((K, self.num_classes), dtype=torch.float32,
                          device=flat.device)
        for k in range(K):
            params = unflatten_like(flat[k], self.template)
            for b in np.flatnonzero(live[k]):
                pred = torch.argmax(
                    self._logits(params, x[k, b * B:(b + 1) * B]), dim=-1)
                acc[k].index_add_(0, pred, valid[k, b * B:(b + 1) * B])
        return acc / torch.clamp(valid.sum(dim=1), min=1.0)[:, None]
