"""Staleness-windowed versioned base store (§IV-C2 distribution). Port of
``repro/core/base_store.py``.

The scheduler bounds every in-flight client to within ``tau`` versions of
the global model, so at most ``tau + 2`` global versions are referenced at
once. The server keeps:

* a ring of the last ``tau + 2`` canonical flat reconstructions ``R_v``
  (slot ``v % (tau + 2)``), ``R_0`` the warmed-up model and
  ``R_{v+1} = R_v + decode(chain_{v+1})``, on the model's device;
* one chain record per retained transition ``v -> v+1``: the compacted
  CSR payload and its stored count on the csr wire, the quantized payload
  (``qvals, qoffs, qcnt, scale``) and its stored count on the csr_q wire
  (the ring already holds the dequantized reconstruction, so replaying
  the chain stays canonical f32), the survivor count on the dense_masked
  wire, the dense size with sparsification disabled;
* a per-client ``base_version`` array and a ``detached`` mask on the host.

Distribution is a chain-delta broadcast: each retained transition goes on
the wire once per round and a client at version ``v`` takes the suffix
``v+1 ..`` it needs. Chain stored-counts stay device scalars until
``dist_payload_bytes()`` reads them.

Churn (the fault layer): a departed client is *detached*, its version
parked but no longer holding back ring eviction; a rejoiner whose version
is still in the window takes the chain suffix, one whose version was
evicted takes an explicit full-model resync, ``n * 4`` bytes on the wire.
``state_dict`` / ``load_state_dict`` carry the whole store through a fleet
checkpoint; the ring is written in place, so a snapshot copies it.

``DenseBaseStore`` is the paper's own distribution state
(``base_store="dense"``, ``feds3a.py:559-615``): one flat base row per
client, the model it last received, and its version. Each round the
server sends every target the sparse difference between the new global
model and that target's row, and the row takes what the target decoded.
With sparsification on its bytes and models differ from the versioned
store's; with it off the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fleet_ckpt


class VersionedBaseStore:
    """Ring of ``tau + 2`` canonical reconstructions + chain payloads."""

    def __init__(self, global_flat, M, tau):
        self.n = int(global_flat.shape[0])
        self.M = int(M)
        self.tau = int(tau)
        self.depth = self.tau + 2
        flat = global_flat.to(torch.float32)
        # written in place at advance(): the ring owns its storage
        self.ring = flat.expand(self.depth, self.n).clone()
        self._latest = flat.clone()
        # which version each ring slot holds (-1 = never written)
        self.slot_version = np.full(self.depth, -1, np.int64)
        self.slot_version[0] = 0
        self.client_version = np.zeros(self.M, np.int64)
        # offline (churned-out) clients: their parked version no longer
        # holds back ring eviction
        self.detached = np.zeros(self.M, bool)
        self.version = 0
        # version v -> {"stored": count[, "vals", "idx"]} (csr), or
        # {"stored", "qvals", "qoffs", "qcnt", "scale"} (csr_q)
        self._chain = {}
        self._dist_pending = []      # (count device scalar, bytes/element)
        self._dist_host = 0.0

    # -- lookups -----------------------------------------------------------
    def slot(self, version):
        return int(version) % self.depth

    def slots_for(self, client_ids):
        """(K,) ring slot of each client's base version, on the ring's
        device."""
        return torch.as_tensor(
            self.client_version[np.asarray(client_ids)] % self.depth,
            device=self.ring.device)

    def gather(self, client_ids):
        """(K, N) base rows for ``client_ids``: a ring lookup by version."""
        return self.ring.index_select(0, self.slots_for(client_ids))

    def gather_cols(self, slots, s, e):
        """(K, e - s) columns ``[s, e)`` of the ring rows ``slots``
        (``ring[:, s:e][slots]``): one chunk's bases, with no (K, N) copy."""
        return self.ring[:, s:e].index_select(0, slots).contiguous()

    def latest(self):
        """R_version, the canonical reconstruction of the newest global."""
        return self._latest

    # -- round transition --------------------------------------------------
    def advance(self, new_recon, payload, new_version):
        """Install ``R_{new_version}`` and its chain payload. Raises if the
        evicted ring slot still holds a version a client references: the
        scheduler's tau-forcing makes that impossible, so a raise means the
        staleness window was violated upstream."""
        if new_version != self.version + 1:
            raise ValueError(f"advance must be sequential: at version "
                             f"{self.version}, got {new_version}")
        slot = self.slot(new_version)
        evicted = self.slot_version[slot]
        if evicted >= 0 and bool(
                ((self.client_version == evicted) & ~self.detached).any()):
            raise RuntimeError(
                f"ring eviction would drop version {evicted} still "
                f"referenced by an attached client (window depth "
                f"{self.depth}, new version {new_version})")
        self.ring[slot] = new_recon
        self._latest = new_recon
        self.slot_version[slot] = new_version
        self.version = new_version
        self._chain[new_version] = payload
        # the stalest target is a forced client at new - tau - 1, whose
        # suffix starts at new - tau: exactly tau + 1 entries stay live
        for v in [v for v in self._chain if v < new_version - self.tau]:
            del self._chain[v]

    # -- churn -------------------------------------------------------------
    def detach(self, client_ids):
        """Park departed clients: the version stays recorded (an in-window
        rejoiner takes the chain suffix it missed) but stops holding back
        ring eviction."""
        ids = np.asarray(sorted(set(int(i) for i in client_ids)), np.int64)
        if ids.size:
            self.detached[ids] = True

    def split_rejoined(self, client_ids, new_version):
        """Rejoiners at the ``new_version`` boundary as ``(chain_ids,
        resync_ids)``: a client parked at ``v`` needs transitions ``v+1 ..
        new_version``, retained iff ``v >= new_version - tau - 1``; a
        staler one was evicted while away and needs the whole model."""
        chain, resync = [], []
        for i in sorted(set(int(c) for c in client_ids)):
            if self.client_version[i] >= new_version - self.tau - 1:
                chain.append(i)
            else:
                resync.append(i)
        return chain, resync

    def resync(self, comm, client_ids):
        """Serve rejoiners whose version left the ring the full model, a
        dense unicast of ``n * 4`` bytes each booked on ``comm``, and
        re-attach them at the current version."""
        ids = np.asarray(sorted(set(int(i) for i in client_ids)), np.int64)
        if ids.size == 0:
            return
        comm.account_dense_payload(float(ids.size) * self.n * 4, self.n,
                                   int(ids.size))
        self._dist_host += float(ids.size) * self.n * 4
        self.client_version[ids] = self.version
        self.detached[ids] = False

    def account_distribution(self, comm, targets):
        """Book this round's chain-delta broadcast onto ``comm``: the
        suffix from the stalest target's version, each transition payload
        once however many clients listen (CSR payloads with their row_ptr
        and, on csr_q, their scales and block tables; dense_masked
        survivors without framing). With sparsification disabled every
        chain payload is the whole dense model, so the broadcast is ONE
        dense payload. Then bumps the targets to the new version."""
        targets = np.asarray(sorted(set(int(t) for t in targets)), np.int64)
        if not targets.size:
            return
        vers = self.client_version[targets]
        if (vers >= self.version).any():
            raise ValueError("distribution target already at (or past) "
                             "the current version")
        if not comm.enabled:
            comm.account_batch(None, self.n, 1)
            self._dist_host += self.n * 4
        else:
            stored = [self._chain[t]["stored"]
                      for t in range(int(vers.min()) + 1, self.version + 1)]
            total = torch.stack([s.reshape(()) for s in stored]).sum()
            self._dist_pending.append((total, sum(comm.elem_bytes())))
            csr = comm.wire_format in ("csr", "csr_q")
            comm.account_payload(total, self.n, len(stored),
                                 row_ptr_rows=len(stored) if csr else 0)
            if csr:
                sb, bb = comm.row_overhead_bytes(self.n)
                self._dist_host += 4 * (len(stored) + 1) + \
                    (sb + bb) * len(stored)
        self.client_version[targets] = self.version
        self.detached[targets] = False

    # -- checkpoint / restore ----------------------------------------------
    def state_dict(self, *, defer=False):
        """The whole mutable state: the ring, the chain records, the
        per-client versions and detached mask, the distribution bytes.
        ``defer=False`` gives host numpy (the pending byte counts folded).
        ``defer=True`` (the checkpoint writer's path) waits for nothing: the
        ring, which ``advance`` writes in place, is copied on its device;
        chain tensors, never written after their round, are kept by
        reference; the stored counts and the pending byte fold are
        ``fleet_ckpt.Lazy`` values the writer thread resolves, the same
        fold in the same order. The live store is left as it is."""
        if defer:
            base, pend = float(self._dist_host), list(self._dist_pending)

            def dist():
                out = base
                for cnt, eb in pend:
                    out += float(cnt.to(torch.float64).item()) * eb
                return out

            dist = fleet_ckpt.Lazy(dist)

            def conv(k, arr):
                if k == "stored" and isinstance(arr, torch.Tensor):
                    return fleet_ckpt.Lazy(lambda a=arr: a.cpu().numpy())
                return arr

            ring = self.ring.clone()
        else:
            dist = float(self.dist_payload_bytes())

            def conv(k, arr):
                if isinstance(arr, torch.Tensor):
                    return arr.cpu().numpy()
                return arr

            ring = self.ring.cpu().numpy()
        chain = [[int(v), {k: conv(k, a) for k, a in self._chain[v].items()}]
                 for v in sorted(self._chain)]
        return {"n": self.n, "M": self.M, "tau": self.tau, "ring": ring,
                "slot_version": self.slot_version.copy(),
                "client_version": self.client_version.copy(),
                "detached": self.detached.copy(),
                "version": int(self.version), "chain": chain,
                "dist_host": dist}

    def load_state_dict(self, d):
        """Restore ``state_dict`` output onto a store of the same geometry
        (n, M and tau are checked); tensors go to the ring's device with
        their saved dtypes, and the newest reconstruction is read back from
        its ring slot (``advance`` writes it there bit for bit)."""
        for k in ("n", "M", "tau"):
            if int(d[k]) != getattr(self, k):
                raise ValueError(f"base-store state has {k}={d[k]}, this "
                                 f"store has {k}={getattr(self, k)}")
        dev = self.ring.device

        def tensor(a):
            if isinstance(a, np.ndarray):
                return torch.from_numpy(a).to(dev)
            return a

        self.ring = torch.from_numpy(np.asarray(d["ring"], np.float32)
                                     .reshape(self.depth, self.n)).to(dev)
        self.slot_version = np.asarray(d["slot_version"],
                                       np.int64).reshape(self.depth).copy()
        self.client_version = np.asarray(d["client_version"],
                                         np.int64).reshape(self.M).copy()
        self.detached = np.asarray(d["detached"], bool).reshape(self.M).copy()
        self.version = int(d["version"])
        self._latest = self.ring[self.slot(self.version)].clone()
        self._chain = {int(v): {k: tensor(a) for k, a in entry.items()}
                       for v, entry in d["chain"]}
        self._dist_pending = []
        self._dist_host = float(d["dist_host"])

    # -- reporting ---------------------------------------------------------
    def dist_payload_bytes(self):
        """Cumulative distribution bytes on the wire (broadcast payloads
        only). Materializes pending device scalars on read."""
        if self._dist_pending:
            counts = torch.stack([c.to(torch.float64)
                                  for c, _ in self._dist_pending]).cpu()
            for cnt, (_, eb) in zip(counts.tolist(), self._dist_pending):
                self._dist_host += cnt * eb
            self._dist_pending = []
        return self._dist_host

    def bytes(self):
        """Server memory held by the store: the ring (O(tau * N)), the
        retained chain payloads (O(tau * cap)) and the per-client arrays
        (O(M))."""
        total = self.ring.numel() * 4 + self.client_version.nbytes + \
            self.detached.nbytes
        for p in self._chain.values():
            for k, arr in p.items():
                if k == "stored":
                    total += 4                           # stored count
                else:
                    total += int(arr.numel()) * arr.element_size()
        return int(total)


class DenseBaseStore:
    """One flat (N,) float32 base row per client, on the model's device, as
    an (M, N) tensor written in place, and the (M,) version each row holds
    on the host. Every row starts as the warmed-up global model."""

    def __init__(self, global_flat, M):
        self.n = int(global_flat.shape[0])
        self.M = int(M)
        self.rows = global_flat.to(torch.float32).expand(self.M,
                                                         self.n).clone()
        self.client_version = np.zeros(self.M, np.int64)

    def _index(self, client_ids):
        return torch.as_tensor(np.asarray(client_ids, np.int64),
                               device=self.rows.device)

    def gather(self, client_ids):
        """(K, N) base rows of ``client_ids``."""
        return self.rows.index_select(0, self._index(client_ids))

    def write(self, client_ids, new_rows, version):
        """A distribution's write-back: row ``client_ids[t]`` becomes
        ``new_rows[t]`` (what target t decoded) at ``version``."""
        self.rows.index_copy_(0, self._index(client_ids),
                              new_rows.to(torch.float32))
        self.client_version[np.asarray(client_ids, np.int64)] = version

    def bytes(self):
        """Server memory of the per-client base state, the reference's
        logical footprint (``feds3a.py:1952-1970``): every client's row and
        the version array, O(M * N)."""
        return int(self.M * self.n * 4 + self.client_version.nbytes)
