"""The paper's comparison algorithms (§V-F1) on PyTorch, adapted to the
disjoint FSSL scenario as the paper adapts them: the server's supervised
model joins each global update with the dynamic supervised weight. Port of
``repro/core/baselines.py``.

* FedAvg-SSL-Partial: 6 clients drawn each round, synchronous;
* FedAvg-SSL-All: every client each round, synchronous;
* FedAsync-SSL: aggregate on every single arrival (FedAsync mixing,
  polynomial staleness, a forced sync past staleness 16);
* Local-SSL: the centralized semi-supervised ceiling.

The model is always the full paper CNN, the module attribute
``CNN_CONFIG``, whatever ``config.cnn`` says, as in the reference. Random
draws: ``np.random.default_rng(seed)`` draws FedAvg-SSL-Partial's
selections and nothing else; the dropout masks of every epoch come from
seeds drawn from a second host generator, ``default_rng((seed,
0x5EED))``, as ``FedS3ATrainer`` draws them (``feds3a.seeded_masks``).
Everything runs on ``config.device``, the card by default.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.configs.feds3a_cnn import CONFIG as CNN_CONFIG
from repro_torch.core import aggregation as agg
from repro_torch.core import pseudo_label
from repro_torch.core.feds3a import (FedS3AConfig, _resolve_device,
                                     seeded_masks)
from repro_torch.core.functions import supervised_weight
from repro_torch.core.metrics import weighted_metrics
from repro_torch.core.scheduler import paper_latency
from repro_torch.models.cnn import init_cnn
from repro_torch.optimizer import adam_init
from repro_torch.weights import params_from_numpy


class _Base:
    def __init__(self, data, config: FedS3AConfig | None = None, *,
                 init_params=None):
        """``init_params``: optional {name: numpy array} starting weights
        (before the server warm-up) in place of a draw from the seed; the
        tests pass the reference's own initial weights."""
        self.cfg = cfg = config or FedS3AConfig()
        self.device = _resolve_device(cfg.device)
        # the reference is float32 throughout: no TF32 in products or convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.data = data
        self.M = len(data["clients"])
        self.cnn = CNN_CONFIG
        self.client_epoch = pseudo_label.make_client_epoch(
            self.cnn, batch_size=cfg.batch_size, threshold=cfg.threshold,
            l1=cfg.l1)
        self.server_epoch = pseudo_label.make_server_epoch(
            self.cnn, batch_size=cfg.batch_size, l1=cfg.l1)
        self.predict = pseudo_label.predict_fn(self.cnn)
        sizes = [len(c["x"]) for c in data["clients"]]
        ref_total = 453004      # Table III basic total
        f = ref_total / max(sum(sizes), 1)
        self.latencies = [paper_latency(int(s * f)) for s in sizes]
        self.np_rng = np.random.default_rng(cfg.seed)
        self.seed_rng = np.random.default_rng((cfg.seed, 0x5EED))

        if init_params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            params = init_cnn(self.cnn, gen)
        else:
            params = params_from_numpy(init_params, self.device)
        opt = adam_init(params)
        for _ in range(cfg.init_server_epochs):
            params, opt, _ = self._server_epoch(params, opt)
        self.global_params = params
        self.server_opt = opt
        self.comm_bytes = 0
        self.dense_bytes = 0

    def _epoch_masks(self, n_rows, epochs=None):
        """Dropout masks (epochs, nb, B, hidden) for one run of ``epochs``
        epochs over ``n_rows`` rows (one epoch, (nb, B, hidden), when
        ``epochs`` is None), from one seed of ``seed_rng``; None without
        dropout."""
        B = self.cfg.batch_size
        nb = max((n_rows + B - 1) // B, 1)
        prefix = (nb,) if epochs is None else (epochs, nb)
        return seeded_masks(self.cnn, self.device,
                            self.seed_rng.integers(0, 2**63 - 1),
                            (*prefix, B))

    def _server_epoch(self, params, opt):
        server = self.data["server"]
        return self.server_epoch(params, opt, server["x"], server["y"],
                                 self.cfg.lr,
                                 self._epoch_masks(len(server["x"])))

    def _count_comm(self, n_msgs):
        n = sum(v.numel() for v in self.global_params.values())
        self.comm_bytes += n_msgs * n * 4
        self.dense_bytes += n_msgs * n * 4

    def _train_client(self, i, params, lr):
        """Client i's local epochs from ``params``; each epoch has its own
        masks (the reference's ``fold_in(k, e)``)."""
        x = self.data["clients"][i]["x"]
        masks = self._epoch_masks(len(x), self.cfg.epochs)
        opt = adam_init(params)
        for e in range(self.cfg.epochs):
            params, opt, _ = self.client_epoch(
                params, opt, x, lr, None if masks is None else masks[e])
        return params

    def _server_step(self):
        sp, self.server_opt, _ = self._server_epoch(self.global_params,
                                                    self.server_opt)
        return sp

    def evaluate(self):
        test = self.data["test"]
        x = torch.as_tensor(test["x"], dtype=torch.float32,
                            device=self.device)
        preds = self.predict(self.global_params, x).cpu().numpy()
        return weighted_metrics(test["y"], preds, self.cnn.num_classes)

    @property
    def aco(self):
        # an empty ledger reads 0.0, as SparseComm.aco does
        return self.comm_bytes / self.dense_bytes if self.dense_bytes else 0.0


class FedAvgSSL(_Base):
    """Synchronous FedAvg adapted to FSSL. ``mode``: ``"partial"``
    (``per_round`` clients drawn each round) or ``"all"``. ``selections``
    (port only) keeps each round's client ids."""

    def __init__(self, data, config=None, *, mode="partial", per_round=6,
                 init_params=None):
        super().__init__(data, config, init_params=init_params)
        self.mode = mode
        self.per_round = per_round if mode == "partial" else self.M
        self.selections = []

    def train(self, rounds=None):
        rounds = rounds or self.cfg.rounds
        arts = []
        for r in range(rounds):
            sel = (self.np_rng.choice(self.M, self.per_round, replace=False)
                   if self.mode == "partial" else np.arange(self.M))
            self.selections.append([int(i) for i in sel])
            models, sizes = [], []
            for i in sel:
                models.append(self._train_client(i, self.global_params,
                                                 self.cfg.lr))
                sizes.append(len(self.data["clients"][i]["x"]))
            sp = self._server_step()
            fw = supervised_weight(r, C=self.per_round / self.M, M=self.M,
                                   mode=self.cfg.supervised_weight_mode)
            self.global_params = agg.fedavg_ssl(sp, models, sizes, fw)
            self._count_comm(2 * len(sel))
            arts.append(max(self.latencies[i] for i in sel))
        return {"metrics": self.evaluate(), "art": float(np.mean(arts)),
                "aco": self.aco, "rounds": rounds}


class FedAsyncSSL(_Base):
    """FedAsync adapted to FSSL: a global update on every arrival.
    ``arrivals`` (port only) keeps each aggregated arrival's client id in
    event order."""

    def __init__(self, data, config=None, *, alpha=0.9, a=0.5, max_stale=16,
                 init_params=None):
        super().__init__(data, config, init_params=init_params)
        self.alpha = alpha
        self.a = a
        self.max_stale = max_stale
        self.forced_syncs = 0
        self.arrivals = []

    def train(self, rounds=None):
        rounds = rounds or self.cfg.rounds
        # event loop: every client trains continuously; each arrival is a
        # round, ties broken by client id
        heap = []
        version = {i: 0 for i in range(self.M)}
        base = {i: self.global_params for i in range(self.M)}
        for i in range(self.M):
            heapq.heappush(heap, (self.latencies[i], i))
        times = []
        g_version = 0
        prev_t = 0.0
        r = 0
        while r < rounds:
            t, i = heapq.heappop(heap)
            s = g_version - version[i]
            if s > self.max_stale:
                # forced sync: the upload would be too stale to blend, so
                # only the fresh model crosses the wire (one downlink); the
                # client restarts from it and no round is consumed
                version[i] = g_version
                base[i] = self.global_params
                self._count_comm(1)
                self.forced_syncs += 1
                heapq.heappush(heap, (t + self.latencies[i], i))
                continue
            newp = self._train_client(i, base[i], self.cfg.lr)
            sp = self._server_step()
            fw = supervised_weight(r, C=1 / self.M, M=self.M,
                                   mode=self.cfg.supervised_weight_mode)
            blended = agg.fedasync_blend(self.global_params, newp,
                                         staleness=s, alpha=self.alpha,
                                         a=self.a)
            self.global_params = {
                k: (fw * v.to(torch.float32)
                    + (1 - fw) * blended[k].to(torch.float32)).to(v.dtype)
                for k, v in sp.items()}
            g_version += 1
            version[i] = g_version
            base[i] = self.global_params
            self._count_comm(2)
            heapq.heappush(heap, (t + self.latencies[i], i))
            self.arrivals.append(i)
            times.append(t - prev_t)
            prev_t = t
            r += 1
        return {"metrics": self.evaluate(), "art": float(np.mean(times)),
                "aco": self.aco, "rounds": rounds,
                "forced_syncs": self.forced_syncs}


class LocalSSL(_Base):
    """Centralized semi-supervised ceiling: the labeled server data and the
    pooled unlabeled client data, pseudo-label training."""

    def train(self, rounds=None):
        rounds = rounds or self.cfg.rounds
        x_all = np.concatenate([c["x"] for c in self.data["clients"]])
        params, opt = self.global_params, adam_init(self.global_params)
        uopt = adam_init(params)
        for _ in range(rounds):
            params, opt, _ = self._server_epoch(params, opt)
            params, uopt, _ = self.client_epoch(
                params, uopt, x_all, self.cfg.lr,
                self._epoch_masks(len(x_all)))
        self.global_params = params
        return {"metrics": self.evaluate(), "art": float("nan"),
                "aco": float("nan"), "rounds": rounds}
