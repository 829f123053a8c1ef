"""The FedS3A trainer on PyTorch: the semi-async scheduler, pseudo-label
client training, group-based staleness-weighted aggregation, adaptive
learning rates and sparse-difference communication. Port of
``repro/core/feds3a.py`` with two of its round engines, selected by
``engine=``:

* ``"sequential"``: one client after another (``feds3a.py:955-1032``),
  the reference's parity anchor;
* ``"batched"``: the participants' models as one (K, N) flat stack, all K
  trained together one stacked step per batch index, the uploads encoded
  in one call and aggregated from flat vectors (``feds3a.py:1223-1356``);
* ``None``: batched on the card; on the CPU batched for models of at most
  300,000 parameters, sequential above (``feds3a.py:435-471``; the
  sharded engine is not ported, so the rule never picks it).

Wires: the compacted ``"csr"`` wire, the quantized ``"csr_q"`` wire
(``q_dtype="int8"`` or ``"fp16"``), the ``"dense_masked"`` wire, and the
disabled channel (``sparse_comm=False``). Base stores (``base_store=``),
for every engine and wire: ``"versioned"`` keeps the reconstructions and
the chain, and distributes by a chain-delta broadcast; ``"dense"``, the
paper's own scheme, keeps each client's base row and sends every target
the sparse difference between the new global model and that row
(``feds3a.py:559-615, 686-703, 1106-1135``). With
``error_feedback=True`` every client keeps a residual: what its last
upload did not deliver, re-offered with the next one, and zeroed when the
scheduler force-restarts the client.

Chunked parameter axis (``chunk_size=``, ``param_layout=``,
``layer_keep_frac=``; ``core/param_layout.py``): the flat vector splits
into leaf-aligned chunks, and the round's upload encode, server blend and
ring advance go one chunk at a time, each chunk with its own capacity and
keep fraction (``feds3a.py:1361-1576``). Both engines then run the same
stacked round body, so a chunked sequential run is the chunked batched run
bit for bit; a layout of one chunk without overrides is the flat path.

Client stores (``client_store=``): ``"resident"`` keeps the residuals as
one dense (M, N) tensor on the device (chunked: (M, rcap) CSR pages) and
the stacked engines' padded client data as (M, nb*B, F)
(``feds3a.py:578-605``); ``"paged"`` keeps
both on the host (``core/client_store.py``; a pooled fleet dataset's P
distinct shards only) and puts only the round's K participants on the
device (``feds3a.py:473-519, 618-635``). A paged run is a memory layout,
not an algorithm: it gives its resident twin's results bit for bit.

A round: the scheduler admits ``ceil(C * M)`` uploads; each participant
trains one pseudo-label epoch from its base and uploads its delta;
the server takes one supervised epoch; clients are grouped by k-means on
their pseudo-label histograms; Eq. 9/10 aggregates; one chain-transition
encode advances the versioned base store, and its broadcast is booked
(dense store: one encode a target against its own base row).

Random draws: every round takes one seed per participant, in arrival
order, then one for the server, from a host generator seeded with
``cfg.seed``; each seeds a device generator that draws its epoch's dropout
masks at once. Both engines consume the same seeds and masks, so they can
be compared with dropout on.

Faults (``traffic=``, a ``core/traffic.py`` profile, ``round_deadline=``,
``quorum_floor=``; ``feds3a.py:755-924``): the scheduler draws crashes,
lost and corrupt uploads, churn and late joins from its own stream, and
aggregates a degraded quorum at the deadline. The trainer quarantines
corrupt uploads at the trust boundary (``SparseComm.validate_payload``),
detaches departures from the ring window, serves rejoiners the chain
suffix or a booked full-model resync, and retires the EF residuals of
forced, lost, corrupted, departed and rejoined clients. Every engine and
wire takes rounds of any K from ``quorum_floor`` to ``ceil(C * M)``.

Fleet checkpoints (``checkpoint_dir=``, ``checkpoint_every=``;
``feds3a.py:2069-2358``, protocol in ``core/fleet_ckpt.py``):
``save_checkpoint()`` writes the whole round-boundary state (global model,
server Adam state, every RNG stream, EF residuals, ring and chain,
scheduler heaps, ledgers, paged pages, round logs); ``restore()`` on a
fresh trainer of the same config resumes it bit for bit. With
``wait=False`` (``train()``'s cadence) the snapshot copies what the next
round writes in place (the ring, the resident residuals) on the device
before it returns, and a writer thread does the host copies and the disk.

Everything runs on ``FedS3AConfig.device``, the card by default. A model
on the card goes through the CUDA kernels (``kernels/ops.py``); a model on
the CPU through their plain versions. Config values outside the ported
slice raise ``NotImplementedError`` naming the ROADMAP queue that brings
them.
"""
from __future__ import annotations

import os
import queue
import threading
import warnings
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.feds3a_cnn import CONFIG as CNN_CONFIG
from repro_torch.core import aggregation as agg
from repro_torch.core import fleet_ckpt
from repro_torch.core.base_store import DenseBaseStore, VersionedBaseStore
from repro_torch.core.client_store import (PagedClientStore, ResidentStore,
                                           take_to_device)
from repro_torch.core.functions import (adaptive_learning_rates,
                                        staleness_fn, supervised_weight)
from repro_torch.core.grouping import group_clients
from repro_torch.core.metrics import fleet_health, weighted_metrics
from repro_torch.core.model_adapter import make_adapter
from repro_torch.core.param_layout import ParamLayout
from repro_torch.core.scheduler import SemiAsyncScheduler, paper_latency
from repro_torch.core.sparse_comm import (CSR_FORMATS, MALFORM_KINDS,
                                          Q_BLOCK, SparseComm,
                                          WireIntegrityError,
                                          csr_page_decode, flatten_tree,
                                          unflatten_like)
from repro_torch.models.cnn import dropout_masks
from repro_torch.optimizer import adam_init
from repro_torch.tree import tree_map
from repro_torch.weights import params_from_numpy

ENGINES = ("sequential", "batched", "sharded")
BASE_STORES = ("versioned", "dense")
CLIENT_STORES = ("resident", "paged")
# auto engine selection on the CPU: stacked rounds win where round overhead
# dominates, the reference's own cut (feds3a.py:458-459)
CPU_BATCHED_MAX_PARAMS = 300_000


@dataclass
class FedS3AConfig:
    rounds: int = 20
    C: float = 0.6                      # participation proportion (§IV-C1)
    tau: int = 2                        # staleness tolerance (§IV-C2)
    lr: float = 1e-4                    # paper Table IV
    batch_size: int = 100
    epochs: int = 1
    server_epochs: int = 1              # accepted, unused, as in the reference
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
    wire_format: str = "csr"            # "csr" | "csr_q" | "dense_masked"
    q_dtype: str = "int8"               # csr_q values: "int8" | "fp16"
    wire_capacity: object = None        # per-row payload capacity override
    residual_frac: float = 0.25         # EF residual: top share of N kept
    base_store: str = "versioned"
    client_store: str = "resident"      # "resident" | "paged"
    paged_dir: object = None            # paged store: memory-map the
                                        # residual pages under this dir
    error_feedback: bool = False
    l1: float = 1e-5                    # §IV-F L1 regularisation
    use_kernels: bool = False           # accepted, changes nothing: a model
                                        # on the card always launches the
                                        # CUDA kernels, one on the CPU
                                        # always takes their plain versions
    engine: object = None               # "sequential" | "batched" | None
    batched: object = None              # legacy alias: True/False map to
                                        # engine="batched"/"sequential" when
                                        # ``engine`` is unset (deprecated)
    cnn: object = None                  # CNNConfig override (None: paper §V-B)
    model: object = None                # a model-zoo ModelConfig: the LM
                                        # as a final-token classifier
    chunk_size: int = 0                 # > 0: leaf-aligned chunks of at
                                        # most this many parameters
    param_layout: object = None         # an explicit ParamLayout (wins
                                        # over chunk_size)
    layer_keep_frac: object = None      # {leaf-name pattern: keep_frac |
                                        # (keep, residual) | dict}
    seed: int = 0
    latency_jitter: float = 0.05
    traffic: object = None              # TrafficModel fault profile
    round_deadline: object = None       # simulated seconds a round waits
    quorum_floor: int = 1               # fewest uploads a degraded round
                                        # takes
    checkpoint_dir: object = None       # fleet checkpoints under this dir
    checkpoint_every: int = 0           # train(): a checkpoint every this
                                        # many global rounds, and at the end
    device: str = "cuda"                # port only: where the round runs


def _resolve_layout(cfg, template):
    """``chunk_size`` / ``param_layout`` / ``layer_keep_frac`` resolved
    to the run's ``ParamLayout`` over the model's parameter ``template``
    (the adapter's: the CNN's dict, or the LM's nested tree), or None for
    the flat path, which a layout of one chunk without overrides is
    (``feds3a.py:414-433``)."""
    layout = cfg.param_layout
    if layout is None:
        if cfg.layer_keep_frac and not cfg.chunk_size:
            raise ValueError(
                "layer_keep_frac requires chunk_size > 0 or an explicit "
                "param_layout: per-layer sparsity is a property of the "
                "leaf-aligned chunks")
        if not cfg.chunk_size:
            return None
        layout = ParamLayout.from_template(template, cfg.chunk_size,
                                           overrides=cfg.layer_keep_frac)
    return None if layout.is_flat else layout


def _lm_later(what):
    return (f"FedS3AConfig.model with {what} is outside the ported slice; "
            f"it comes with ROADMAP.md 'Still to port' queue 3b (the FL "
            f"language-model path)")


# what the FL language-model path does not take yet (ROADMAP.md queue 3b):
# each of these runs the LM through code that no test holds against the
# reference
LM_LATER = (
    ("base_store='dense'", lambda c: c.base_store == "dense"),
    ("client_store='paged'", lambda c: c.client_store == "paged"),
)


def _check_slice(cfg, template):
    """Refuse invalid config values (``ValueError``, as the reference
    does), then every value this slice does not port, naming the
    ROADMAP.md queue ("Still to port") that brings it. Returns the
    ``ParamLayout`` resolved over ``template`` (None: the flat path)."""
    if cfg.engine not in ENGINES + (None,):
        raise ValueError(f"engine must be one of {ENGINES} or None, got "
                         f"{cfg.engine!r}")
    if cfg.base_store not in BASE_STORES:
        raise ValueError(f"base_store must be one of {BASE_STORES}, got "
                         f"{cfg.base_store!r}")
    if cfg.client_store not in CLIENT_STORES:
        raise ValueError(f"client_store must be one of {CLIENT_STORES}, "
                         f"got {cfg.client_store!r}")
    if cfg.client_store == "paged" and cfg.base_store != "versioned":
        raise ValueError(
            "client_store='paged' requires base_store='versioned': the "
            "paged layout keeps no per-client base state; a client's base "
            "is its ring version, already on the host")
    if cfg.traffic is not None and cfg.base_store != "versioned":
        raise ValueError(
            "fault injection (traffic=) requires base_store='versioned': "
            "rejoin re-basing (chain suffix vs full-model resync) is defined "
            "against the reconstruction ring")
    if cfg.checkpoint_dir is not None and cfg.base_store != "versioned":
        raise ValueError(
            "checkpoint_dir requires base_store='versioned': the checkpoint "
            "snapshots the reconstruction ring + chain; the legacy dense "
            "per-client base state has no serialized form")
    layout = _resolve_layout(cfg, template)
    if layout is not None:
        if not (cfg.sparse_comm and cfg.wire_format in CSR_FORMATS):
            raise ValueError(
                "chunked layouts require a CSR-family wire format with "
                "sparse_comm enabled: the chunked round streams compacted "
                "per-chunk payloads")
        if cfg.base_store != "versioned":
            raise ValueError(
                "chunked layouts require base_store='versioned': chunk "
                "bases are gathered from the reconstruction ring one chunk "
                "at a time")
    if cfg.model is not None:
        for what, outside in LM_LATER:
            if outside(cfg):
                raise NotImplementedError(_lm_later(what))
    later = {
        "engine": (cfg.engine == "sharded", "4 (sharded engine)"),
    }
    for name, (outside, label) in later.items():
        if outside:
            raise NotImplementedError(
                f"FedS3AConfig.{name} is outside the ported slice; it comes "
                f"with ROADMAP.md 'Still to port' queue {label}")
    return layout


def _resolve_device(name):
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "FedS3AConfig.device is 'cuda' but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    return device


def select_engine(engine, device, n_params, batched=None):
    """``cfg.engine`` resolved: the legacy ``batched`` True/False, when
    set, stands for an unset engine (with a ``DeprecationWarning``, as in
    the reference); None is batched on the card, and on the CPU batched up
    to ``CPU_BATCHED_MAX_PARAMS`` parameters, sequential above
    (compute-bound CPU training gains nothing from stacking)."""
    if batched is not None:
        warnings.warn(
            "FedS3AConfig(batched=...) is deprecated since the engine "
            "selector landed; use engine='batched' / engine="
            "'sequential' instead", DeprecationWarning, stacklevel=3)
        if engine is None:
            engine = "batched" if batched else "sequential"
    if engine is not None:
        return engine
    if device.type == "cuda" or n_params <= CPU_BATCHED_MAX_PARAMS:
        return "batched"
    return "sequential"


def seeded_masks(cnn, device, seed, shape):
    """Dropout keep-masks (*shape, hidden) on ``device`` from one draw of a
    device generator seeded with ``seed`` (a host draw); None without
    dropout."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return dropout_masks(cnn, shape, gen)


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
        """``init_params``: optional starting weights (before the server
        warm-up) in place of a draw from the seed, a tree of numpy arrays:
        {name: array} for the CNN, the LM's nested dicts and lists; the
        tests pass the reference's own initial weights."""
        self.cfg = config or FedS3AConfig()
        cfg = self.cfg
        self.cnn = cfg.cnn if cfg.cnn is not None else CNN_CONFIG
        # one adapter owns every model closure: the paper CNN's
        # pseudo_label factories, or a model-zoo ModelConfig's LM as a
        # final-token classifier (``feds3a.py:298-341``); the chunk layout
        # is resolved over its parameter template
        self.adapter = make_adapter(
            cfg.model if cfg.model is not None else self.cnn,
            batch_size=cfg.batch_size, threshold=cfg.threshold, l1=cfg.l1,
            epochs=cfg.epochs)
        self.layout = _check_slice(cfg, self.adapter.template)
        self.chunked = self.layout is not None
        self.device = _resolve_device(cfg.device)
        # the reference is float32 throughout: no TF32 in products or convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.data = data
        self.M = len(data["clients"])
        self.paged = self.cfg.client_store == "paged"
        B = cfg.batch_size
        self.engine = select_engine(self.cfg.engine, self.device,
                                    self.adapter.param_count(),
                                    self.cfg.batched)
        # the stacked round body: the batched engine's, and the chunked
        # round's on both engines (same seeds, masks and arithmetic)
        self.stacked = self.engine == "batched" or self.chunked
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.cfg.seed)
        # per-round seeds: participants in arrival order, then the server
        self.seed_rng = np.random.default_rng((self.cfg.seed, 0x5EED))

        self.client_epoch = self.adapter.client_epoch
        self.server_epoch = self.adapter.server_epoch
        self.predict = self.adapter.predict
        self.histogram = self.adapter.histogram
        if self.stacked:
            self.batched_epoch = self.adapter.batched_epoch
            self.histogram_batch = self.adapter.histogram_batch
            self.server_epoch_flat = self.adapter.server_epoch_flat
            self._build_padded_data()

        sizes = [len(c["x"]) for c in data["clients"]]
        self.num_batches = [max((s + B - 1) // B, 1) for s in sizes]
        # the paper's latency model is on unscaled Table III sizes
        ref_total = 453004  # Table III basic total
        f = ref_total / max(sum(sizes), 1)
        self.latencies = [paper_latency(int(s * f)) for s in sizes]
        self.scheduler = SemiAsyncScheduler(
            self.latencies, C=cfg.C, tau=cfg.tau, jitter=cfg.latency_jitter,
            seed=cfg.seed, traffic=cfg.traffic, deadline=cfg.round_deadline,
            quorum_floor=cfg.quorum_floor)
        self.comm = SparseComm(cfg.sparse_threshold, enabled=cfg.sparse_comm,
                               wire_format=cfg.wire_format,
                               capacity=cfg.wire_capacity,
                               residual_frac=cfg.residual_frac,
                               q_dtype=cfg.q_dtype, layout=self.layout)
        self._csr_wire = self.comm.enabled and \
            self.comm.wire_format in CSR_FORMATS
        self._quantized = self._csr_wire and self.comm.wire_format == "csr_q"
        self.g_fn = staleness_fn(cfg.staleness_function)
        self.participation = np.zeros((0, self.M))
        self.logs: list[RoundLog] = []
        # checkpoints: each round log's encoding, made once a run (logs are
        # append-only), and the writer thread, started at the first
        # background save (at most one write in flight)
        self._log_pack: list[bytes] = []
        self._ckpt_thread = None
        self._ckpt_queue = None
        self._ckpt_exc = None
        self._init_models(init_params)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def _build_padded_data(self):
        """Every client's data padded to the fleet's largest batch count,
        once, as (rows, nb*B, F) and (rows, nb*B) validity stacks
        (``feds3a.py:473-502``). Resident: all M clients, on the device.
        Paged: on the host, and of a pooled fleet dataset (``data["pool"]``,
        M clients aliasing P distinct shards) only the P distinct rows,
        with ``_data_map`` sending client i to its shard's row."""
        B = self.cfg.batch_size
        pool = self.data.get("pool") if self.paged else None
        rows = min(int(pool), self.M) if pool else self.M
        clients = self.data["clients"][:rows]
        nb = max(max((len(c["x"]) + B - 1) // B, 1) for c in clients)
        xs = np.zeros((rows, nb * B, clients[0]["x"].shape[1]), np.float32)
        valid = np.zeros((rows, nb * B), np.float32)
        for i, c in enumerate(clients):
            xs[i, :len(c["x"])] = c["x"]
            valid[i, :len(c["x"])] = 1.0
        self._pad_batches = nb
        if self.paged:
            self._x_pad_h, self._valid_pad_h = xs, valid
            self._data_map = np.arange(self.M, dtype=np.int64) % rows
            self._data_row_bytes = int(xs[0].nbytes + valid[0].nbytes)
        else:
            self._x_pad = torch.from_numpy(xs).to(self.device)
            self._valid_pad = torch.from_numpy(valid).to(self.device)

    def _gather_data(self, ids):
        """Participants' padded data rows on the device. Resident: a
        device-side index. Paged: a host index, then a copy of just the
        window (the same values, bit for bit)."""
        if self.paged:
            rows = self._data_map[np.asarray(ids, np.int64)]
            xs = take_to_device(self._x_pad_h, rows, self.device)
            vs = take_to_device(self._valid_pad_h, rows, self.device)
            self._data_window_bytes = int(xs.nbytes + vs.nbytes)
            return xs, vs
        idx = torch.as_tensor(ids, device=self.device)
        return self._x_pad[idx], self._valid_pad[idx]

    def _draw_seeds(self, k):
        """This round's k participant seeds, in arrival order, then the
        server's: one host draw, no device sync."""
        return self.seed_rng.integers(0, 2**63 - 1, size=k + 1)

    def _masks(self, seed, prefix):
        """The CNN's dropout masks from ``seed``; None for the LM, which
        has no dropout."""
        if self.adapter.kind != "cnn":
            return None
        return seeded_masks(self.cnn, self.device, seed,
                            (*prefix, self.cfg.batch_size))

    def _server_masks(self, seed):
        n = len(self.data["server"]["x"])
        B = self.cfg.batch_size
        return self._masks(seed, (max((n + B - 1) // B, 1),))

    def _init_models(self, init_params):
        cfg = self.cfg
        if init_params is None:
            params = self.adapter.init(self.gen)
        else:
            params = params_from_numpy(init_params, self.device)
        opt = adam_init(params)
        # Algorithm 1: the server warms up on labeled data before
        # distributing
        for _ in range(cfg.init_server_epochs):
            seed = self.seed_rng.integers(0, 2**63 - 1)
            params, opt, _ = self.server_epoch(
                params, opt, self.data["server"]["x"],
                self.data["server"]["y"], cfg.lr, self._server_masks(seed))
        self._template = params
        self.global_params = params
        self._global_flat = flatten_tree(params)
        self.server_opt = opt
        if self.stacked:
            # the server's Adam state carries over from the warm-up, flat
            self.server_opt = {"m": flatten_tree(opt["m"])[None],
                               "v": flatten_tree(opt["v"])[None],
                               "t": opt["t"].reshape(1)}
        # one zeroed Adam state for every sequential client restart (never
        # written); the stacked body zeroes its own rows
        self._zero_opt = None if self.stacked else adam_init(params)
        self.dense_store = cfg.base_store == "dense"
        if self.dense_store:
            # each client's base row; every client starts a round from its
            # row with a zeroed Adam state, as the reference's per-client
            # params / opt always are then (``feds3a.py:606-615``; pinned by
            # tests/test_torch_dense_store.py), so neither is kept
            self.store = DenseBaseStore(self._global_flat, self.M)
        else:
            self.store = VersionedBaseStore(self._global_flat, self.M,
                                            cfg.tau)
        # late joiners start offline: parked at version 0 and detached, so
        # they never hold back ring eviction; they attach through the
        # rejoin path at their first online boundary
        if self.scheduler.initial_offline:
            self.store.detach(self.scheduler.initial_offline)
        self.global_version = 0
        # EF keeps a residual per client (a disabled channel delivers
        # everything: its residual stays zero, and none is kept)
        ef = cfg.error_feedback and self.comm.enabled
        n = self._global_flat.shape[0]
        self.cstore = None
        self._data_window_bytes = 0
        if self.paged:
            # host pages and a device window of the participants' pages:
            # CSR pages on the CSR wires, dense rows on dense_masked
            layout = ("csr" if self._csr_wire else "dense") if ef else "none"
            rcap = self.comm.residual_capacity_total() if self.chunked \
                else self.comm.residual_capacity(n)
            self.cstore = PagedClientStore(
                self.M, n, rcap, layout=layout, paged_dir=cfg.paged_dir,
                device=self.device)
            self.cstore.adopt_versions(self.store.client_version,
                                       self.store.detached)
        elif ef and self.chunked:
            # chunked: (M, rcap_total) CSR pages with global columns
            # (``feds3a.py:579-587``)
            self.cstore = ResidentStore(
                self.M, n, device=self.device, layout="csr",
                rcap=self.comm.residual_capacity_total())
        elif ef:
            # the resident store: one dense row per client on the device
            self.cstore = ResidentStore(self.M, n, device=self.device)
        # how the residuals travel: "csr" pages, "dense" rows, or None
        self._ef_layout = None if self.cstore is None or \
            self.cstore.layout == "none" else self.cstore.layout

    @property
    def global_params(self):
        """The global model as a tree. The batched engine keeps it flat
        and unflattens on demand."""
        if self._gp_tree is None:
            self._gp_tree = unflatten_like(self._global_flat, self._template)
        return self._gp_tree

    @global_params.setter
    def global_params(self, tree):
        self._gp_tree = tree

    @property
    def base_versions(self):
        """(M,) per-client base model versions."""
        return self.store.client_version.copy()

    # ------------------------------------------------------------------
    def _advance_encode(self, new_flat, prev):
        """ONE chain-transition encode of the new global model against the
        previous canonical reconstruction (the reference's
        ``_advance_encode_body`` and ``_chain_entry``): ``(R_{r+1}, chain
        entry)``. On csr_q the entry keeps the quantized payload and R_{r+1}
        adds its dequantized decode. Disabled: R_{r+1} is the new model
        itself, bit for bit. Chunked: one encode a chunk, the chain entry's
        payloads concatenated (``chunk_advance_body``)."""
        keys = ("qvals", "qoffs", "qcnt", "scale") if self._quantized \
            else ("vals", "idx")
        if self.chunked:
            recon, chain = self.comm.chunk_advance_body()(new_flat, prev)
            return recon, dict(zip(keys + ("stored",), chain))
        if self._csr_wire:
            payload, stored, decoded = self.comm.csr_core(new_flat[None],
                                                          prev[None])
            chain = {k: p[0] for k, p in zip(keys, payload)}
            chain["stored"] = stored[0]
            return prev + decoded[0], chain
        if not self.comm.enabled:
            return new_flat, {"stored": new_flat.shape[0]}
        masked, nnz = self.comm.batch_core(new_flat[None], prev[None])
        return prev + masked[0], {"stored": nnz[0]}

    def _distribution_plan(self, part_ids, ev):
        """Who restarts from the new global model at this boundary, and how
        (``feds3a.py:755-779``): ``(targets, resync)``. ``targets`` take
        the chain-delta broadcast: the online participants, the tau-forced
        clients, the lost and quarantined uploaders (they listen for the
        broadcast like any uploader) and the rejoiners still inside the
        window; ``resync`` are rejoiners whose version left the ring, who
        take the full model. A participant that left after uploading stays
        aggregated but gets nothing. Fault-free this is participants |
        forced. Fills ``ev.resynced`` for the round log."""
        online = self.scheduler.state.online
        chain, resync = [], []
        if ev.rejoined:
            chain, resync = self.store.split_rejoined(ev.rejoined,
                                                      self.global_version)
        targets = sorted(set(i for i in part_ids if online[i])
                         | set(ev.forced) | set(ev.lost)
                         | set(ev.corrupted) | set(chain))
        ev.resynced = resync
        return targets, resync

    @staticmethod
    def _retired_ids(ev):
        """Clients whose EF residual is retired at this boundary
        (``feds3a.py:781-794``): tau-forced restarts, lost and quarantined
        uploaders and rejoiners (a fresh base, so a fresh residual), and
        departures (their trajectory is gone). After the upload encode,
        which a departed participant's residual legitimately fed."""
        return sorted(set(ev.forced) | set(ev.lost) | set(ev.corrupted)
                      | set(ev.departed) | set(ev.rejoined))

    def _advance_versioned(self, recon, chain, ev, part_ids):
        """Install the new reconstruction + chain entry, detach the
        departures first (an offline client must not hold back the
        window), book the chain-delta broadcast and any full-model
        resyncs, and retire the dead residuals (``feds3a.py:796-811``)."""
        targets, resync = self._distribution_plan(part_ids, ev)
        if ev.departed:
            self.store.detach(ev.departed)
        self.store.advance(recon, chain, self.global_version)
        self.store.account_distribution(self.comm, targets)
        if resync:
            self.store.resync(self.comm, resync)
        self._reset_forced_residuals(self._retired_ids(ev))

    def _distribute_dense(self, ev, part_ids, new_flat):
        """The dense store's distribution (``feds3a.py:686-703, 1017-1031,
        1336-1351``): each target of ``_distribution_plan`` gets the sparse
        difference between the new global model and its own base row, and
        the row becomes what the target decoded, at the new version; then
        the forced clients' residuals retire. The sequential engine encodes
        and books one target at a time (``SparseComm.encode``, a (1, N)
        call of each of the wire's kernels); the batched engine encodes the
        (T, N) stack of the targets' rows in one call
        (``SparseComm.distribute_core``) and books it as one batch."""
        targets, _ = self._distribution_plan(part_ids, ev)
        v, n = self.global_version, new_flat.shape[0]
        if self.engine == "sequential":
            for i in targets:
                base = unflatten_like(self.store.gather([i])[0],
                                      self._template)
                delta, _ = self.comm.encode(self.global_params, base)
                row = flatten_tree(self.comm.apply(base, delta)) \
                    if self.comm.enabled else new_flat
                self.store.write([i], row[None], v)
        elif targets:
            new_base, counts = self.comm.distribute_core(
                new_flat, self.store.gather(targets))
            if self._csr_wire:
                self.comm.account_batch_csr(counts, n, len(targets))
            else:
                self.comm.account_batch(counts, n, len(targets))
            self.store.write(targets, new_base, v)
        self._reset_forced_residuals(ev.forced)

    def _reset_forced_residuals(self, ids):
        """Retire the EF residuals of ``ids`` (``_retired_ids``): each was
        accumulated against a base the client no longer holds
        (``feds3a.py:813-848``). The resident store zeroes the rows (or
        pages) at once; the paged store queues the invalidations after this
        round's write-back, as the resident sequence orders them."""
        if ids and self._ef_layout is not None:
            self.cstore.retire(sorted(set(ids)))

    def _quarantine_uploads(self, ev):
        """Run every corrupt-fated upload through the wire-integrity check
        at the trust boundary (``feds3a.py:850-895``). The scheduler decided
        which runs were damaged (``ev.corrupted``); here the damage is
        materialized, one of ``MALFORM_KINDS`` picked by a client / round
        hash (engine-independent, replayable), and
        ``SparseComm.validate_payload`` must reject it. Rejection is the
        quarantine: the payload is never decoded, aggregated or booked (the
        lost-upload path; the residual retires in ``_retired_ids``). A
        malformed payload that passed validation would poison the
        aggregate, so that raises. Host only; the dense wires carry no
        payload arrays to damage, as in the reference."""
        if not ev.corrupted or not self._csr_wire:
            return
        n = int(self._global_flat.shape[0])
        cap = 4                       # any capacity: validation infers it
        stored = np.full(1, cap, np.int64)
        if self._quantized:
            vdt = np.int8 if self.comm.q_dtype == "int8" else np.float16
            blocks = np.zeros((1, (n + Q_BLOCK - 1) // Q_BLOCK), np.int64)
            blocks[0, 0] = cap
            nominal = {"nnz": stored, "total": n, "rows": 1,
                       "values": np.zeros((1, cap), vdt),
                       "indices": np.zeros((1, cap), np.int16),
                       "blocks": blocks, "scales": np.ones(1, np.float32)}
        else:
            nominal = {"nnz": stored, "total": n, "rows": 1,
                       "values": np.zeros((1, cap), np.float32),
                       "indices": np.zeros((1, cap), np.int32)}
        for c in ev.corrupted:
            kind = MALFORM_KINDS[
                (c * 2654435761 + self.global_version) % len(MALFORM_KINDS)]
            bad = self.comm.malform_stats(nominal, kind)
            try:
                self.comm.validate_payload(bad)
            except WireIntegrityError:
                continue              # quarantined
            raise RuntimeError(
                f"malformed upload (client {c}, kind {kind!r}) passed "
                f"wire-integrity validation: quarantine is broken")

    # ------------------------------------------------------------------
    def run_round(self):
        if self.chunked:
            return self._run_round_chunked()
        if self.engine == "batched":
            return self._run_round_batched()
        return self._run_round_sequential()

    def _round_prologue(self):
        """Advance the scheduler one boundary and quarantine its corrupt
        uploads: ``(prev_time, ev, lrs)``."""
        prev_time = self.scheduler.state.time
        ev = self.scheduler.next_round()
        self._quarantine_uploads(ev)
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
        if self.paged:
            self.cstore.record_participation(part_ids,
                                             self.global_version - 1)
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

    def _groups(self, hists):
        """k-means groups of the participants' pseudo-label histograms
        (K, C) on the host, or None for the flat Eq. 9."""
        K = len(hists)
        if not (self.cfg.group_based and K > 1):
            return None
        return group_clients(np.asarray(hists), min(self.cfg.num_groups, K),
                             seed=self.cfg.seed)

    # -- sequential engine ---------------------------------------------
    def _train_client(self, i, lr, seed):
        """Run client i's local epochs from its base (a ring lookup, or its
        dense-store row) with a zeroed Adam state; returns (trained, base)
        parameter dicts."""
        x = self.data["clients"][i]["x"]
        base = unflatten_like(self.store.gather([i])[0], self._template)
        masks = self._masks(seed, (self.cfg.epochs, self.num_batches[i]))
        params, opt = base, self._zero_opt
        for e in range(self.cfg.epochs):
            params, opt, _ = self.client_epoch(
                params, opt, x, lr, None if masks is None else masks[e])
        return params, base

    def _run_round_sequential(self):
        cfg = self.cfg
        prev_time, ev, lrs = self._round_prologue()
        r = self.global_version
        part_ids = [run.client for run in ev.participants]
        seeds = self._draw_seeds(len(part_ids))

        client_models, sizes, stalenesses, hists = [], [], [], []
        layout = self._ef_layout
        for j, i in enumerate(part_ids):
            newp, base = self._train_client(i, float(lrs[i]), seeds[j])
            if layout == "csr":
                # the residual is a CSR page: gather it, fold its decode
                # into the encode, queue the new page back
                rv, rx = self.cstore.gather_csr([i])
                delta, _, (nrv, nrx) = self.comm.encode_paged(
                    newp, base, rv[0], rx[0])
                self.cstore.scatter_csr([i], nrv[None], nrx[None])
            elif layout == "dense":
                row = self.cstore.gather_dense([i])[0]
                delta, _, res = self.comm.encode(
                    newp, base, residual=unflatten_like(row, newp))
                self.cstore.scatter_dense([i], flatten_tree(res)[None])
            else:
                delta, _ = self.comm.encode(newp, base)
            uploaded = self.comm.apply(base, delta)
            client_models.append(uploaded)
            x = self.data["clients"][i]["x"]
            sizes.append(len(x))
            stalenesses.append(ev.stale[i])
            hists.append(self.histogram(uploaded, self._tensor(x))
                         .cpu().numpy())

        # server supervised epoch on the current global model (Eq. 6)
        sp, self.server_opt, _ = self.server_epoch(
            self.global_params, self.server_opt, self.data["server"]["x"],
            self.data["server"]["y"], cfg.lr, self._server_masks(seeds[-1]))

        fw = supervised_weight(r, C=cfg.C, M=self.M,
                               mode=cfg.supervised_weight_mode)
        self.global_params = agg.aggregate(
            sp, client_models, data_sizes=sizes, stalenesses=stalenesses,
            g_fn=self.g_fn, f_weight=fw, groups=self._groups(hists))
        self._global_flat = flatten_tree(self.global_params)
        self.global_version += 1

        # distribution: one chain-transition encode + its broadcast, or
        # one encode a target against its own row
        if self.dense_store:
            self._distribute_dense(ev, part_ids, self._global_flat)
        else:
            recon, chain = self._advance_encode(self._global_flat,
                                                self.store.latest())
            self._advance_versioned(recon, chain, ev, part_ids)
        return self._round_epilogue(prev_time, ev)

    # -- batched engine ------------------------------------------------
    def _stacked_masks(self, part_ids, seeds):
        """(K, epochs, nb, B, hidden) dropout masks: participant j's own
        draw (``_train_client``'s, from the same seed) in its first nb_j
        batches; the padding batches, which never step, keep everything."""
        nb = self._pad_batches
        out = None
        for j, i in enumerate(part_ids):
            m = self._masks(seeds[j], (self.cfg.epochs, self.num_batches[i]))
            if m is None:
                return None
            if out is None:
                out = torch.ones((len(part_ids), self.cfg.epochs, nb)
                                 + m.shape[2:], dtype=torch.bool,
                                 device=self.device)
            out[j, :, :m.shape[1]] = m
        return out

    def _upload(self, trained, base_flat, part_ids, xs, vs, with_hist):
        """Encode and book the K uploads, advancing the participants' EF
        residuals; returns (what the aggregation reads, histograms or
        None): the CSR or csr_q payload with its stored counts, or the
        uploaded (K, N) stack on the dense wires (``feds3a.py:1051-1134,
        1268-1290``)."""
        K, n = trained.shape
        layout = self._ef_layout
        residual = None
        if layout == "csr":
            # the participants' pages decode to their dense rows inside the
            # encode; the new residuals leave as pages
            residual = csr_page_decode(*self.cstore.gather_csr(part_ids), n)
        elif layout == "dense":
            residual = self.cstore.gather_dense(part_ids)
        if self._csr_wire:
            payload, stored, decoded, *res = self.comm.csr_core(
                trained, base_flat, residual, pages=layout == "csr")
            self.comm.account_batch_csr(stored, n, K)
            # the uploaded models, in the decode's own memory
            uploaded = decoded.add_(base_flat) if with_hist else None
            sent = payload + (stored,)
        else:
            if self.comm.enabled:
                masked, nnz, *res = self.comm.batch_core(trained, base_flat,
                                                         residual)
            else:
                masked, nnz = trained - base_flat, None
            self.comm.account_batch(nnz, n, K)
            # the uploaded models, in the masked stack's own memory (the
            # sum is base + masked's bits): at a language model's width
            # another (K, n) stack is 7.85 GB a 2-layer qwen2
            uploaded = sent = masked.add_(base_flat)
        if layout == "csr":
            self.cstore.scatter_csr(part_ids, *res[0])
        elif layout == "dense":
            self.cstore.scatter_dense(part_ids, res[0])
        hists = self.histogram_batch(uploaded, xs, vs).cpu().numpy() \
            if with_hist else None
        return sent, hists

    def _run_round_batched(self):
        """All participants per stage: one stacked epoch, one upload
        encode, one aggregation and one chain-transition encode, or on the
        dense store one (T, N) distribution encode (``feds3a.py:1223-1356``).
        One host transfer per round beyond the scheduler's: the histograms
        that feed k-means."""
        cfg = self.cfg
        prev_time, ev, lrs = self._round_prologue()
        r = self.global_version
        part_ids = [run.client for run in ev.participants]
        K = len(part_ids)
        seeds = self._draw_seeds(K)

        xs, vs = self._gather_data(part_ids)
        base_flat = self.store.gather(part_ids)
        trained, _ = self.batched_epoch(base_flat, xs, vs, lrs[part_ids],
                                        self._stacked_masks(part_ids, seeds))
        sent, hists = self._upload(trained, base_flat, part_ids, xs, vs,
                                   cfg.group_based and K > 1)

        # server supervised epoch on the current global model (Eq. 6)
        sp_flat, self.server_opt, _ = self.server_epoch_flat(
            self._global_flat, self.server_opt, self.data["server"]["x"],
            self.data["server"]["y"], cfg.lr, self._server_masks(seeds[-1]))

        fw = supervised_weight(r, C=cfg.C, M=self.M,
                               mode=cfg.supervised_weight_mode)
        w = agg.combine_weights(
            [len(self.data["clients"][i]["x"]) for i in part_ids],
            [ev.stale[i] for i in part_ids], self.g_fn,
            None if hists is None else self._groups(hists))
        self.global_version += 1
        if self._quantized:
            new_flat = agg.blend_flat_csr_q(sp_flat, base_flat, *sent, w, fw)
        elif self._csr_wire:
            new_flat = agg.blend_flat_csr(sp_flat, base_flat, *sent, w, fw)
        else:
            new_flat = agg.blend_flat(sp_flat, sent, w, fw)
        if self.dense_store:
            self._distribute_dense(ev, part_ids, new_flat)
        else:
            recon, chain = self._advance_encode(new_flat,
                                                self.store.latest())
            self._advance_versioned(recon, chain, ev, part_ids)
        self._global_flat = new_flat
        self._gp_tree = None
        return self._round_epilogue(prev_time, ev)

    # -- chunked round body (``feds3a.py:1361-1576``) --------------------
    def _chunk_upload(self, trained, slots, part_ids, xs, vs, with_hist):
        """Encode and book the K uploads one chunk at a time
        (``SparseComm.chunk_encode_body``), advancing the participants' EF
        pages: (per-chunk payloads, each with its stored counts last, and
        the histograms or None). Only one chunk's delta, decode and
        residual are alive at a time: with the histograms, the bases are
        read from the (K, N) uploaded stack they need, each chunk's before
        its decode is added in; without, they are gathered from the ring
        by slot a chunk at a time (``feds3a.py:1361-1412``)."""
        K, n = trained.shape
        pages = ()
        if self._ef_layout == "csr":
            pages = self.cstore.gather_csr(part_ids)
        if with_hist:
            up = self.store.ring.index_select(0, slots)

            def base(s, e):
                return up[:, s:e]

            def sink(p, decoded):
                up[:, p["s"]:p["e"]] += decoded
        else:
            def base(s, e):
                return self.store.gather_cols(slots, s, e)

            def sink(p, decoded):
                pass
        payloads, stored, _, *new_pages = self.comm.chunk_encode_body(
            bool(pages))(trained, base, *pages, sink=sink)
        if pages:
            self.cstore.scatter_csr(part_ids, *new_pages[0])
        self.comm.account_batch_csr(sum(stored), n, K)
        hists = self.histogram_batch(up, xs, vs).cpu().numpy() \
            if with_hist else None
        return [pay + (st,) for pay, st in zip(payloads, stored)], hists

    def _chunk_blend(self, sp_flat, slots, sent, w, fw):
        """The server blend a chunk at a time: each chunk's payloads
        against its ring-gathered (K, nc) bases (``blend_flat_csr`` /
        ``_csr_q`` on the chunk), the results concatenated
        (``feds3a.py:1414-1449``)."""
        blend = agg.blend_flat_csr_q if self._quantized else \
            agg.blend_flat_csr
        out = []
        for p, payload in zip(self.comm.chunk_plan(), sent):
            s, e = p["s"], p["e"]
            out.append(blend(sp_flat[s:e], self.store.gather_cols(slots, s, e),
                             *payload, w, fw))
        return torch.cat(out)

    def _run_round_chunked(self):
        """One round over the chunked parameter axis, for both engines
        (``feds3a.py:1475-1576``): the stacked epoch from the participants'
        ring bases (the sequential engine too: the same seeds, masks and
        per-client arithmetic), then the upload encode, the server blend
        and the ring advance one chunk at a time, the uploads booked as one
        batch with the chunked framing."""
        cfg = self.cfg
        prev_time, ev, lrs = self._round_prologue()
        r = self.global_version
        part_ids = [run.client for run in ev.participants]
        K = len(part_ids)
        seeds = self._draw_seeds(K)

        xs, vs = self._gather_data(part_ids)
        trained, _ = self.batched_epoch(self.store.gather(part_ids), xs, vs,
                                        lrs[part_ids],
                                        self._stacked_masks(part_ids, seeds))
        slots = self.store.slots_for(part_ids)
        sent, hists = self._chunk_upload(trained, slots, part_ids, xs, vs,
                                         cfg.group_based and K > 1)
        del trained

        # server supervised epoch on the current global model (Eq. 6)
        sp_flat, self.server_opt, _ = self.server_epoch_flat(
            self._global_flat, self.server_opt, self.data["server"]["x"],
            self.data["server"]["y"], cfg.lr, self._server_masks(seeds[-1]))

        fw = supervised_weight(r, C=cfg.C, M=self.M,
                               mode=cfg.supervised_weight_mode)
        w = agg.combine_weights(
            [len(self.data["clients"][i]["x"]) for i in part_ids],
            [ev.stale[i] for i in part_ids], self.g_fn,
            None if hists is None else self._groups(hists))
        self.global_version += 1
        new_flat = self._chunk_blend(sp_flat, slots, sent, w, fw)
        del sent
        recon, chain = self._advance_encode(new_flat, self.store.latest())
        self._advance_versioned(recon, chain, ev, part_ids)
        self._global_flat = new_flat
        self._gp_tree = None
        return self._round_epilogue(prev_time, ev)

    # -- memory reporting (``feds3a.py:1578-1595, 1951-2060``) ---------
    def peak_delta_device_bytes(self):
        """The reference's analytic peak device bytes of one round's delta
        pipeline for the k = ceil(C * M) expected participants: delta and
        decode (k, width) f32 (two more with EF: the residual's expansion
        and spill) and the (k, cap) f32 + int32 payload, at width N on the
        flat path and max_chunk under a layout (O(k * chunk), flat in N).
        The eager port holds more at its peak: the uploaded (k, N) stack
        the histograms read and every chunk's payload until the blend
        (measured on the card by ``chip_smoke.py`` phase 5d)."""
        k = max(int(np.ceil(self.cfg.C * self.M)), 1)
        n = self._global_flat.shape[0]
        if self.chunked:
            chunk = self.layout.max_chunk
            cap = max(p["cap"] for p in self.comm.chunk_plan())
        else:
            chunk = n
            cap = self.comm.payload_capacity(n) if self._csr_wire else n
        bufs = 2 + (2 if self.cfg.error_feedback else 0)
        return int(4 * k * chunk * bufs + 8 * k * cap)

    def base_store_bytes(self):
        """Server bytes of the per-client base state: the versioned store's
        ring, retained chain payloads and version array
        (``VersionedBaseStore.bytes``), or the dense store's M rows and
        versions (``DenseBaseStore.bytes``)."""
        return self.store.bytes()

    def residual_store_bytes(self):
        """Bytes of the per-client EF residual state (0 without EF): the
        resident (M, N) float32 tensor (chunked: the (M, rcap) CSR pages)
        on the device, or the paged store's nominal host pages."""
        return 0 if self.cstore is None else self.cstore.residual_store_bytes()

    def client_state_device_bytes(self):
        """Device bytes of per-client state: resident, the (M, N) residual
        and the batched engine's (M, nb*B, F) padded data, linear in M;
        paged, the last round's participant window and its queued pages,
        O(K), flat in M."""
        total = 0 if self.cstore is None else \
            self.cstore.device_window_bytes()
        if self.paged:
            total += self._data_window_bytes
        elif self.stacked:
            total += self._x_pad.nbytes + self._valid_pad.nbytes
        return int(total)

    def client_state_host_bytes(self):
        """Nominal host bytes of per-client state: paged, the store's pages,
        counters and the adopted versions, plus the host data stack the
        batched engine pages from; resident, the versions alone."""
        if not self.paged:
            return int(self.store.client_version.nbytes)
        total = self.cstore.host_bytes()
        if self.stacked:
            total += int(self._x_pad_h.nbytes + self._valid_pad_h.nbytes
                         + self._data_map.nbytes)
        return total

    def client_state_resident_equiv_bytes(self):
        """What the resident layout puts on the device at this fleet size:
        the stacked engines' padded data stack and, under EF, the dense
        (M, N) residual (chunked: the (M, rcap_total) CSR pages)."""
        total = 0
        if self.stacked:
            total += self.M * self._data_row_bytes if self.paged else \
                int(self._x_pad.nbytes + self._valid_pad.nbytes)
        if self.cfg.error_feedback and self.comm.enabled:
            total += self.M * (self.comm.residual_capacity_total() * 8
                               if self.chunked else
                               self._global_flat.shape[0] * 4)
        return total

    # -- fleet checkpoints (``feds3a.py:2069-2358``, core/fleet_ckpt.py) --
    def _ef_kind(self):
        """The serialized form of the EF residuals (part of the
        fingerprint): "none", "paged" (the pages ride in the ``cstore``
        section), or the resident store's "dense" rows / "csr" pages."""
        if self._ef_layout is None:
            return "none"
        return "paged" if self.paged else self.cstore.layout

    def _ef_state(self, defer):
        kind = self._ef_kind()
        if kind in ("dense", "csr"):
            return {"kind": kind, **self.cstore.state_dict(defer=defer)}
        return {"kind": kind}

    def _load_ef_state(self, d):
        kind = self._ef_kind()
        if d["kind"] != kind:
            raise ValueError(f"checkpoint EF state is {d['kind']!r}, this "
                             f"trainer stores {kind!r}")
        if kind in ("dense", "csr"):
            self.cstore.load_state_dict(d)

    def _ckpt_fingerprint(self):
        """What a checkpoint must match to restore: the meaning of the
        saved state depends on all of it (the chunk plan, the wire's
        payload shapes, the engine's round body, the EF layout, the seed
        behind every RNG stream)."""
        cfg = self.cfg
        chunks = [[int(p["s"]), int(p["e"])] for p in self.comm.chunk_plan()] \
            if self.chunked else None
        wire = self.comm.wire_format if self._csr_wire else "dense"
        return {"format": fleet_ckpt.FORMAT_VERSION,
                "M": int(self.M), "n": int(self._global_flat.shape[0]),
                "engine": self.engine, "wire_fmt": wire,
                "q_dtype": str(cfg.q_dtype), "base_store": cfg.base_store,
                "client_store": str(cfg.client_store),
                "error_feedback": bool(cfg.error_feedback),
                "ef_kind": self._ef_kind(), "tau": int(cfg.tau),
                "C": float(cfg.C), "seed": int(cfg.seed),
                "sparse_comm": bool(cfg.sparse_comm),
                "sparse_threshold": str(cfg.sparse_threshold),
                "chunks": chunks}

    def _ckpt_drain(self):
        """Wait for the background write in flight, if any, and raise what
        it failed with."""
        if self._ckpt_queue is not None:
            self._ckpt_queue.join()
        if self._ckpt_exc is not None:
            exc, self._ckpt_exc = self._ckpt_exc, None
            raise exc

    def _ckpt_submit(self, job):
        """Hand ``job`` to the writer thread (started at the first call);
        its exception surfaces at the next ``_ckpt_drain``. The writer
        holds the trainer weakly and drops each job (and the snapshot it
        owns) once written; it ends when the trainer is freed."""
        if self._ckpt_thread is None:
            self._ckpt_queue = queue.Queue()
            trainer = weakref.ref(self)

            def loop(q=self._ckpt_queue):
                while True:
                    j = q.get()
                    if j is None:           # the trainer was freed
                        q.task_done()
                        return
                    try:
                        j()
                    except BaseException as exc:
                        # kept for the training thread, which re-raises it
                        # at its next drain; the writer must outlive it, or
                        # the next save would wait on a queue nobody serves
                        tr = trainer()
                        if tr is not None:
                            tr._ckpt_exc = exc
                        del tr
                    finally:
                        j = None
                        q.task_done()

            self._ckpt_thread = threading.Thread(
                target=loop, name="fleet-ckpt-writer", daemon=True)
            self._ckpt_thread.start()
            weakref.finalize(self, self._ckpt_queue.put, None)
        self._ckpt_queue.put(job)

    def _ckpt_sections(self, defer):
        """Every section's state, taken on the calling thread. With
        ``defer`` the snapshot owns its data without waiting for the
        device: what the next round writes in place (the ring, the
        resident residuals) and the global model and server Adam state are
        copied on the device; chain payloads and pending byte counts,
        never written again, are kept by reference; host state is copied.
        The writer thread then makes the host copies. Round logs are
        encoded once each, by the writer, into a cache only it touches
        while a write is in flight."""
        keep = (lambda t: t.clone()) if defer else (lambda t: t)
        cache, new_logs = self._log_pack, self.logs[len(self._log_pack):]

        def logs_bytes():
            for log in new_logs:
                cache.append(fleet_ckpt.pack_element(vars(log)))
            return fleet_ckpt.pack_array_of_packed(cache)

        sections = {
            "trainer": {
                "round": int(self.global_version),
                "seed_rng": self.seed_rng.bit_generator.state,
                "gen": self.gen.get_state(),
                "global_flat": keep(self._global_flat),
                "server_opt": tree_map(keep, self.server_opt),
                "participation": self.participation.copy(),
                "ef": self._ef_state(defer),
            },
            "scheduler": self.scheduler.state_dict(),
            "store": self.store.state_dict(defer=defer),
            "comm": self.comm.ledger_state(defer=defer),
            "logs": fleet_ckpt.PrePacked(logs_bytes),
        }
        if self.paged:
            sections["cstore"] = self.cstore.state_dict()
        return sections

    def save_checkpoint(self, *, wait=True):
        """Write one crash-consistent checkpoint of the round-boundary
        state (``core/fleet_ckpt.py``): global model, server Adam state,
        the RNG streams (per-round seeds, the device generator, the
        scheduler's jitter and fault streams), EF residuals, the versioned
        store (ring, chain, versions, detached mask), paged pages,
        scheduler heaps, comm ledgers, participation and round logs,
        committed by a checksummed MANIFEST written last.

        ``wait=False`` returns once the snapshot owns its data (device
        copies of what the next round overwrites); a writer thread makes
        the host copies, encodes and writes, at most one write in flight
        (the next save or ``restore`` waits for it), and its error surfaces
        at the next save or drain. Returns the checkpoint's directory."""
        root = self.cfg.checkpoint_dir
        if not root:
            raise ValueError(
                "save_checkpoint() needs FedS3AConfig(checkpoint_dir=...)")
        self._ckpt_drain()
        rnd = int(self.global_version)
        sections = self._ckpt_sections(defer=not wait)
        fingerprint = self._ckpt_fingerprint()

        def write():
            return fleet_ckpt.write_checkpoint(root, rnd, sections,
                                               fingerprint)

        if wait:
            return write()
        self._ckpt_submit(write)
        return os.path.join(root, f"ckpt-{rnd:08d}")

    def restore(self, checkpoint_dir=None):
        """Resume from the newest restorable checkpoint (a torn one falls
        back to the one before), on a fresh trainer built with the same
        data and config as the writer (the fingerprint is checked);
        ``train()`` then continues bit for bit where the checkpoint left
        off. Returns the restored round."""
        self._ckpt_drain()
        root = checkpoint_dir if checkpoint_dir is not None \
            else self.cfg.checkpoint_dir
        if not root:
            raise ValueError("restore() needs a checkpoint directory")
        path, manifest = fleet_ckpt.find_restorable(root)
        if path is None:
            raise FileNotFoundError(
                f"no restorable checkpoint under {root!r}")
        if manifest.get("fingerprint") != self._ckpt_fingerprint():
            raise ValueError(
                "checkpoint fingerprint mismatch: the checkpoint was "
                "written under a different configuration/layout than this "
                "trainer's")
        tr = fleet_ckpt.read_section(path, "trainer")
        self.global_version = int(tr["round"])
        self.seed_rng.bit_generator.state = tr["seed_rng"]
        self.gen.set_state(torch.from_numpy(tr["gen"]))
        self._global_flat = self._tensor(tr["global_flat"])
        self._gp_tree = None

        def tree(live, saved):
            # the server's Adam state: flat rows on the stacked engines, the
            # model's tree (dicts and lists) on the sequential one
            if isinstance(live, (dict, list)):
                if type(saved) is not type(live) or len(saved) != len(live) \
                        or isinstance(live, dict) and set(live) != set(saved):
                    raise ValueError("checkpoint server_opt has another "
                                     "structure than this trainer's")
                if isinstance(live, list):
                    return [tree(a, b) for a, b in zip(live, saved)]
                return {k: tree(live[k], saved[k]) for k in live}
            return torch.from_numpy(np.asarray(saved)).to(
                device=self.device, dtype=live.dtype).reshape(live.shape)

        self.server_opt = tree(self.server_opt, tr["server_opt"])
        self.participation = np.asarray(tr["participation"],
                                        np.float64).reshape(-1, self.M)
        self._load_ef_state(tr["ef"])
        self.scheduler.load_state_dict(
            fleet_ckpt.read_section(path, "scheduler"))
        self.store.load_state_dict(fleet_ckpt.read_section(path, "store"))
        self.comm.load_ledger_state(fleet_ckpt.read_section(path, "comm"))
        if self.paged:
            self.cstore.load_state_dict(
                fleet_ckpt.read_section(path, "cstore"))
            # the store's load replaced its arrays: adopt the new ones
            self.cstore.adopt_versions(self.store.client_version,
                                       self.store.detached)
        self.logs, self._log_pack = [], []
        for d in fleet_ckpt.read_section(path, "logs"):
            self.logs.append(RoundLog(**d))
        self._data_window_bytes = 0
        return int(tr["round"])

    # ------------------------------------------------------------------
    def evaluate(self, params=None):
        params = params if params is not None else self.global_params
        test = self.data["test"]
        preds = self.predict(params, self._tensor(test["x"])).cpu().numpy()
        return weighted_metrics(test["y"], preds, self.adapter.num_classes)

    def train(self, rounds=None, *, eval_every=0):
        """``rounds`` rounds (default ``cfg.rounds``). With a checkpoint
        directory and ``checkpoint_every``, a background checkpoint every
        ``checkpoint_every`` GLOBAL rounds (so train(50) and
        train(25) + train(25) write the same ones) and one at the end
        unless the cadence just wrote it; the writes are drained before
        the final evaluation."""
        rounds = rounds or self.cfg.rounds
        cfg = self.cfg
        cadence = cfg.checkpoint_dir and cfg.checkpoint_every
        for _ in range(rounds):
            log = self.run_round()
            if eval_every and (log.round + 1) % eval_every == 0:
                log.metrics = self.evaluate()
            if cadence and self.global_version % cfg.checkpoint_every == 0:
                self.save_checkpoint(wait=False)
        if cadence and self.global_version % cfg.checkpoint_every != 0:
            self.save_checkpoint(wait=False)
        self._ckpt_drain()
        final = self.evaluate()
        art = float(np.mean([l.art for l in self.logs]))
        return {"metrics": final, "art": art, "aco": self.comm.aco,
                "rounds": len(self.logs), "fleet": fleet_health(self.logs)}
