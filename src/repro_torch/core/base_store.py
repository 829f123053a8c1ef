"""Staleness-windowed versioned base store (§IV-C2 distribution). Port of
``repro/core/base_store.py:91-264, 352-376``.

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
* a per-client ``base_version`` array on the host.

Distribution is a chain-delta broadcast: each retained transition goes on
the wire once per round and a client at version ``v`` takes the suffix
``v+1 ..`` it needs. Chain stored-counts stay device scalars until
``dist_payload_bytes()`` reads them.

Still to port: churn (detach, rejoin split, full-model resync) and the
checkpoint state.
"""
from __future__ import annotations

import numpy as np
import torch


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
        if evicted >= 0 and bool((self.client_version == evicted).any()):
            raise RuntimeError(
                f"ring eviction would drop version {evicted} still "
                f"referenced by a client (window depth "
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
        total = self.ring.numel() * 4 + self.client_version.nbytes
        for p in self._chain.values():
            for k, arr in p.items():
                if k == "stored":
                    total += 4                           # stored count
                else:
                    total += int(arr.numel()) * arr.element_size()
        return int(total)
