"""The FedS3A trainer on PyTorch: the semi-async scheduler, pseudo-label
client training, group-based staleness-weighted aggregation, adaptive
learning rates and sparse-difference communication. Port of
``repro/core/feds3a.py`` on its sequential engine (the reference's parity
anchor, ``feds3a.py:955-1032``) with the compacted CSR wire and the
versioned base store.

A round: the scheduler admits ``ceil(C * M)`` uploads; each participant
trains one pseudo-label epoch from its ring base and uploads a CSR delta;
the server takes one supervised epoch; clients are grouped by k-means on
their pseudo-label histograms; Eq. 9/10 aggregates; one chain-transition
encode advances the versioned base store, and its broadcast is booked.

Everything runs on ``FedS3AConfig.device``, the card by default. A model
on the card goes through the CUDA kernels (``kernels/ops.py``); a model on
the CPU through their plain versions. Config values outside this slice
raise ``NotImplementedError`` naming the ROADMAP queue that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.feds3a_cnn import CONFIG as CNN_CONFIG
from repro_torch.core import aggregation as agg
from repro_torch.core import pseudo_label
from repro_torch.core.base_store import VersionedBaseStore
from repro_torch.core.functions import (adaptive_learning_rates,
                                        staleness_fn, supervised_weight)
from repro_torch.core.grouping import group_clients
from repro_torch.core.metrics import fleet_health, weighted_metrics
from repro_torch.core.scheduler import SemiAsyncScheduler, paper_latency
from repro_torch.core.sparse_comm import (SparseComm, flatten_tree,
                                          unflatten_like)
from repro_torch.models.cnn import init_cnn
from repro_torch.optimizer import adam_init
from repro_torch.weights import params_from_numpy


@dataclass
class FedS3AConfig:
    rounds: int = 20
    C: float = 0.6                      # participation proportion (§IV-C1)
    tau: int = 2                        # staleness tolerance (§IV-C2)
    lr: float = 1e-4                    # paper Table IV
    batch_size: int = 100
    epochs: int = 1
    init_server_epochs: int = 5         # E_s warmup at r0 (Algorithm 1 l.5-6)
    threshold: float = 0.95             # pseudo-label confidence
    staleness_function: str = "exponential"
    round_weight_function: str = "exponential"
    adaptive_lr: bool = True
    supervised_weight_mode: str = "adaptive"   # adaptive|fixed_alpha|fixed_beta
    num_groups: int = 3
    group_based: bool = True
    sparse_comm: bool = True
    sparse_threshold: object = "p0.2"   # top-20% magnitude per message
    wire_format: str = "csr"
    wire_capacity: object = None        # per-row payload capacity override
    base_store: str = "versioned"
    client_store: str = "resident"
    error_feedback: bool = False
    l1: float = 1e-5                    # §IV-F L1 regularisation
    engine: object = None               # None or "sequential"
    cnn: object = None                  # CNNConfig override (None: paper §V-B)
    model: object = None                # model-zoo config (not ported yet)
    chunk_size: int = 0
    param_layout: object = None
    layer_keep_frac: object = None
    seed: int = 0
    latency_jitter: float = 0.05
    traffic: object = None              # fault profile (not ported yet)
    round_deadline: object = None
    checkpoint_dir: object = None
    device: str = "cuda"                # port only: where the round runs


def _check_slice(cfg):
    """Refuse every config value this slice does not port, naming the
    ROADMAP.md queue ("Still to port") that brings it."""
    later = {
        "engine": (cfg.engine not in (None, "sequential"),
                   "1 (batched engine) or 4 (sharded engine)"),
        "wire_format": (cfg.wire_format != "csr",
                        "1 (dense_masked wire) or 2 (csr_q wire)"),
        "sparse_comm": (not cfg.sparse_comm, "1 (dense wires)"),
        "error_feedback": (bool(cfg.error_feedback), "2 (EF residual store)"),
        "model": (cfg.model is not None, "3 (LM model zoo)"),
        "base_store": (cfg.base_store != "versioned",
                       "4 (legacy dense base store)"),
        "client_store": (cfg.client_store != "resident",
                         "4 (paged client store)"),
        "traffic": (cfg.traffic is not None or cfg.round_deadline is not None,
                    "4 (faults)"),
        "chunk_size": (bool(cfg.chunk_size) or cfg.param_layout is not None
                       or cfg.layer_keep_frac is not None, "4 (chunking)"),
        "checkpoint_dir": (cfg.checkpoint_dir is not None,
                           "4 (fleet checkpoints)"),
    }
    for name, (outside, queue) in later.items():
        if outside:
            raise NotImplementedError(
                f"FedS3AConfig.{name} is outside the ported slice; it comes "
                f"with ROADMAP.md 'Still to port' queue {queue}")


def _resolve_device(name):
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "FedS3AConfig.device is 'cuda' but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    return device


@dataclass
class RoundLog:
    round: int
    time: float
    art: float
    participants: list
    stalenesses: dict
    forced: list
    metrics: dict = field(default_factory=dict)
    degraded: bool = False
    deadline_hit: bool = False
    quorum: int = 0
    target_k: int = 0
    crashes: int = 0
    lost: list = field(default_factory=list)
    departed: list = field(default_factory=list)
    rejoined: list = field(default_factory=list)
    resynced: list = field(default_factory=list)
    corrupted: list = field(default_factory=list)


class FedS3ATrainer:
    def __init__(self, data, config: FedS3AConfig | None = None, *,
                 init_params=None):
        """``init_params``: optional {name: numpy array} starting weights
        (before the server warm-up) in place of a draw from the seed; the
        tests pass the reference's own initial weights."""
        self.cfg = config or FedS3AConfig()
        _check_slice(self.cfg)
        self.device = _resolve_device(self.cfg.device)
        # the reference is float32 throughout: no TF32 in products or convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.data = data
        self.M = len(data["clients"])
        self.cnn = self.cfg.cnn if self.cfg.cnn is not None else CNN_CONFIG
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.cfg.seed)

        cfg = self.cfg
        self.client_epoch = pseudo_label.make_client_epoch(
            self.cnn, batch_size=cfg.batch_size, threshold=cfg.threshold,
            l1=cfg.l1)
        self.server_epoch = pseudo_label.make_server_epoch(
            self.cnn, batch_size=cfg.batch_size, l1=cfg.l1)
        self.predict = pseudo_label.predict_fn(self.cnn)
        self.histogram = pseudo_label.class_histogram(self.cnn)

        sizes = [len(c["x"]) for c in data["clients"]]
        # the paper's latency model is on unscaled Table III sizes
        ref_total = 453004  # Table III basic total
        f = ref_total / max(sum(sizes), 1)
        self.latencies = [paper_latency(int(s * f)) for s in sizes]
        self.scheduler = SemiAsyncScheduler(
            self.latencies, C=cfg.C, tau=cfg.tau, jitter=cfg.latency_jitter,
            seed=cfg.seed)
        self.comm = SparseComm(cfg.sparse_threshold,
                               capacity=cfg.wire_capacity)
        self.g_fn = staleness_fn(cfg.staleness_function)
        self.participation = np.zeros((0, self.M))
        self.logs: list[RoundLog] = []
        self._init_models(init_params)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def _init_models(self, init_params):
        cfg = self.cfg
        if init_params is None:
            params = init_cnn(self.cnn, self.gen)
        else:
            params = params_from_numpy(init_params, self.device)
        opt = adam_init(params)
        # Algorithm 1: the server warms up on labeled data before
        # distributing
        for _ in range(cfg.init_server_epochs):
            params, opt, _ = self.server_epoch(
                params, opt, self.data["server"]["x"],
                self.data["server"]["y"], cfg.lr, self.gen)
        self._template = params
        self.global_params = params
        self.server_opt = opt
        # one zeroed Adam state for every client restart (never written)
        self._zero_opt = adam_init(params)
        self.store = VersionedBaseStore(flatten_tree(params), self.M, cfg.tau)
        self.global_version = 0

    @property
    def base_versions(self):
        """(M,) per-client base model versions."""
        return self.store.client_version.copy()

    # ------------------------------------------------------------------
    def _train_client(self, i, lr):
        """Run client i's local epochs from its ring base; returns
        (trained, base) parameter dicts."""
        x = self.data["clients"][i]["x"]
        base = unflatten_like(self.store.gather([i])[0], self._template)
        params, opt = base, self._zero_opt
        for _ in range(self.cfg.epochs):
            params, opt, _ = self.client_epoch(params, opt, x, lr, self.gen)
        return params, base

    def _advance_encode(self, new_flat, prev):
        """ONE chain-transition encode of the new global model against the
        previous canonical reconstruction (the reference's
        ``_advance_encode_body``): ``(R_{r+1}, chain entry)``."""
        (vals, idx), stored, decoded = self.comm.csr_core(new_flat[None],
                                                          prev[None])
        return prev + decoded[0], {"vals": vals[0], "idx": idx[0],
                                   "stored": stored[0]}

    def _distribution_plan(self, part_ids, ev):
        """Who restarts from the new global model at this boundary: the
        participants and the tau-forced clients (the fault layer, not yet
        ported, adds lost and quarantined uploaders and rejoiners)."""
        return sorted(set(part_ids) | set(ev.forced))

    def _advance_versioned(self, recon, chain, ev, part_ids):
        """Install the new reconstruction + chain payload and book the
        chain-delta broadcast to this round's targets."""
        targets = self._distribution_plan(part_ids, ev)
        self.store.advance(recon, chain, self.global_version)
        self.store.account_distribution(self.comm, targets)

    # ------------------------------------------------------------------
    def run_round(self):
        return self._run_round_sequential()

    def _round_prologue(self):
        """Advance the scheduler one boundary: ``(prev_time, ev, lrs)``."""
        prev_time = self.scheduler.state.time
        ev = self.scheduler.next_round()
        lrs = adaptive_learning_rates(
            self.participation, base_lr=self.cfg.lr,
            round_weight=self.cfg.round_weight_function,
            adaptive=self.cfg.adaptive_lr)
        return prev_time, ev, lrs

    def _round_epilogue(self, prev_time, ev):
        part_ids = [run.client for run in ev.participants]
        row = np.zeros((1, self.M))
        row[0, part_ids] = 1
        self.participation = np.concatenate([self.participation, row])
        log = RoundLog(round=self.global_version - 1, time=ev.time,
                       art=ev.time - prev_time, participants=part_ids,
                       stalenesses={i: ev.stale[i] for i in part_ids},
                       forced=ev.forced, degraded=ev.degraded,
                       deadline_hit=ev.deadline_hit, quorum=ev.quorum,
                       target_k=ev.target_k, crashes=ev.crashes,
                       lost=ev.lost, departed=ev.departed,
                       rejoined=ev.rejoined, resynced=ev.resynced,
                       corrupted=ev.corrupted)
        self.logs.append(log)
        return log

    def _server_step(self):
        """Server supervised epoch on the current global model (Eq. 6)."""
        sp, self.server_opt, _ = self.server_epoch(
            self.global_params, self.server_opt, self.data["server"]["x"],
            self.data["server"]["y"], self.cfg.lr, self.gen)
        return sp

    def _run_round_sequential(self):
        cfg = self.cfg
        prev_time, ev, lrs = self._round_prologue()
        r = self.global_version

        client_models, sizes, stalenesses, hists = [], [], [], []
        for run in ev.participants:
            i = run.client
            newp, base = self._train_client(i, float(lrs[i]))
            delta, _ = self.comm.encode(newp, base)
            uploaded = self.comm.apply(base, delta)
            client_models.append(uploaded)
            x = self.data["clients"][i]["x"]
            sizes.append(len(x))
            stalenesses.append(ev.stale[i])
            hists.append(self.histogram(uploaded, self._tensor(x))
                         .cpu().numpy())

        sp = self._server_step()

        groups = None
        if cfg.group_based and len(client_models) > 1:
            groups = group_clients(np.stack(hists),
                                   min(cfg.num_groups, len(client_models)),
                                   seed=cfg.seed)

        fw = supervised_weight(r, C=cfg.C, M=self.M,
                               mode=cfg.supervised_weight_mode)
        self.global_params = agg.aggregate(
            sp, client_models, data_sizes=sizes, stalenesses=stalenesses,
            g_fn=self.g_fn, f_weight=fw, groups=groups)
        self.global_version += 1

        # distribution: one chain-transition encode + its broadcast
        part_ids = [run.client for run in ev.participants]
        recon, chain = self._advance_encode(flatten_tree(self.global_params),
                                            self.store.latest())
        self._advance_versioned(recon, chain, ev, part_ids)
        return self._round_epilogue(prev_time, ev)

    # ------------------------------------------------------------------
    def evaluate(self, params=None):
        params = params if params is not None else self.global_params
        test = self.data["test"]
        preds = self.predict(params, self._tensor(test["x"])).cpu().numpy()
        return weighted_metrics(test["y"], preds, self.cnn.num_classes)

    def train(self, rounds=None, *, eval_every=0):
        rounds = rounds or self.cfg.rounds
        for _ in range(rounds):
            log = self.run_round()
            if eval_every and (log.round + 1) % eval_every == 0:
                log.metrics = self.evaluate()
        final = self.evaluate()
        art = float(np.mean([l.art for l in self.logs]))
        return {"metrics": final, "art": art, "aco": self.comm.aco,
                "rounds": len(self.logs), "fleet": fleet_health(self.logs)}
