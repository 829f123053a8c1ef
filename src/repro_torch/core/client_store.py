"""Participant-paged client state (``client_store="paged"``). Port of
``repro/core/client_store.py``.

The resident layout keeps the server's per-client state (error-feedback
residual rows, participation counters) as (M, ...) tensors on the device,
so device memory grows with the fleet although a round touches only its K
participants. :class:`PagedClientStore` keeps that state in host memory
(numpy; optionally memory-mapped files) and serves each round a device
*window* holding only the participants' pages:

* round prologue: :meth:`gather_csr` / :meth:`gather_dense` drain the
  queued writes, fancy-index the participants' pages out of the host
  store and copy them to the store's device;
* round epilogue: :meth:`scatter_csr` / :meth:`scatter_dense` queue the
  round's updated pages and :meth:`retire` queues page invalidations
  (tau-forced restarts), where the resident engines write rows.

Writes are deferred: scatter and retire only enqueue, and the queue
drains in order at the next gather (or :meth:`flush`), so a retirement
queued after the same round's scatter zeroes the page exactly as the
resident scatter-then-reset sequence does. A queued page stays on the
device until it drains.

Numerics are the resident layout's bit for bit: a CSR page decodes to
exactly the dense residual row the resident engines store, and a retired
or never-written page reads as exact zeros, the row a resident reset
writes.

On a CUDA device both directions go through pinned host memory: a
gather fills a pinned buffer straight from the pages and copies it with
``non_blocking=True``, and a scatter starts its device-to-host copy into a
pinned buffer at once, the drain waiting only for that copy's event.
Copies change no bit.

:class:`ResidentStore` is the resident layout behind the same interface:
one dense (M, n) residual tensor on the device, or under the chunked
parameter axis (M, rcap) CSR pages, written at once.

Both stores take part in fleet checkpoints (``state_dict`` /
``load_state_dict``): the paged one with its valid pages and counters, the
resident one with its residual arrays.

Per-client versions stay with ``VersionedBaseStore`` (host numpy there);
:meth:`adopt_versions` only references them so that :meth:`host_bytes`
reports the whole host-side footprint. The participation counters
(``part_count``, ``last_round``) live here and are updated from the
trainer's round epilogue.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

LAYOUTS = ("csr", "dense", "none")


def _host(a):
    """A page batch as a host numpy array (a device tensor is copied)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def take_to_device(src, rows, device, good=None):
    """``src[rows]`` as a tensor on ``device``, the rows where ``good`` is
    False read as zeros. On a CUDA device the rows are gathered straight
    into pinned host memory and copied with ``non_blocking=True``: the
    copy is ordered on the current stream before any kernel that reads
    the result, and the caching host allocator keeps the buffer until the
    copy has ended."""
    shape = (len(rows),) + src.shape[1:]
    pinned = device.type == "cuda"
    if pinned:
        buf = torch.empty(shape, dtype=torch.from_numpy(
            np.empty(0, src.dtype)).dtype, pin_memory=True)
        win = buf.numpy()
    else:
        win = np.empty(shape, src.dtype)
        buf = torch.from_numpy(win)
    if good is None or good.all():
        np.take(src, rows, axis=0, out=win, mode="clip")
    else:
        win.fill(0)
        if good.any():
            win[good] = src[rows[good]]
    return buf.to(device, non_blocking=pinned)


def _stage_to_host(arrays):
    """Start the copies of device page batches into pinned host memory:
    (host tensors, an event recorded after the copies), or the arrays as
    they are and None when none of them lies on a CUDA device."""
    if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in arrays):
        return arrays, None
    host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                 .copy_(a, non_blocking=True) for a in arrays)
    event = torch.cuda.Event()
    event.record()
    return host, event


class ResidentStore:
    """The resident layout behind :class:`PagedClientStore`'s interface, on
    ``device``, written at once by a scatter or retire. ``layout``:
    ``"dense"`` keeps every client's dense residual row in one (M, n)
    float32 tensor; ``"csr"`` (the chunked parameter axis) keeps (M, rcap)
    float32 values and int32 GLOBAL column indices, zero pads at column
    0."""

    def __init__(self, M, n, *, device, layout="dense", rcap=None):
        if layout not in ("dense", "csr"):
            raise ValueError(f"layout must be 'dense' or 'csr', got "
                             f"{layout!r}")
        self.M, self.n = int(M), int(n)
        self.layout = layout
        self.device = torch.device(device)
        if layout == "dense":
            self.rows = torch.zeros((self.M, self.n), device=self.device)
            self._arrays = (self.rows,)
        else:
            self.rcap = int(rcap)
            self.res_vals = torch.zeros((self.M, self.rcap),
                                        device=self.device)
            self.res_idx = torch.zeros((self.M, self.rcap),
                                       dtype=torch.int32, device=self.device)
            self._arrays = (self.res_vals, self.res_idx)

    def _index(self, ids):
        return torch.as_tensor(ids, device=self.device)

    def gather_dense(self, ids):
        """(len(ids), n) rows, an index on the device."""
        return self.rows.index_select(0, self._index(ids))

    def scatter_dense(self, ids, rows):
        self.rows.index_copy_(0, self._index(ids), rows)

    def gather_csr(self, ids):
        """(len(ids), rcap) (values, indices) pages, an index on the
        device."""
        idx = self._index(ids)
        return self.res_vals.index_select(0, idx), \
            self.res_idx.index_select(0, idx)

    def scatter_csr(self, ids, vals, idx):
        rows = self._index(ids)
        self.res_vals.index_copy_(0, rows, vals)
        self.res_idx.index_copy_(0, rows, idx)

    def retire(self, ids):
        if len(ids):
            rows = self._index(ids)
            for a in self._arrays:
                a[rows] = 0

    def state_dict(self, *, defer=False):
        """The residual arrays, for a fleet checkpoint: host numpy, or with
        ``defer=True`` copies on the device (scatters and retirements write
        the live arrays in place, so a snapshot taken for a background
        writer must own its data before the next round runs)."""
        copy = (lambda a: a.clone()) if defer else \
            (lambda a: a.cpu().numpy())
        return {"M": self.M, "n": self.n, "layout": self.layout,
                "arrays": [copy(a) for a in self._arrays]}

    def load_state_dict(self, d):
        """Restore ``state_dict`` output onto a store of the same geometry
        and layout."""
        for k in ("M", "n", "layout"):
            if d[k] != getattr(self, k):
                raise ValueError(f"resident-store state has {k}={d[k]!r}, "
                                 f"this store has {k}={getattr(self, k)!r}")
        for dst, src in zip(self._arrays, d["arrays"], strict=True):
            dst.copy_(torch.from_numpy(np.asarray(src)).reshape(dst.shape))

    def residual_row(self, i):
        """Client ``i``'s dense (n,) residual, as a host numpy array (a CSR
        page decoded by scatter-add; its zero pads add nothing)."""
        if self.layout == "dense":
            return self.rows[i].cpu().numpy()
        out = np.zeros(self.n, np.float32)
        np.add.at(out, self.res_idx[i].cpu().numpy(),
                  self.res_vals[i].cpu().numpy())
        return out

    def device_window_bytes(self):
        return int(sum(a.nbytes for a in self._arrays))

    def residual_store_bytes(self):
        return self.device_window_bytes()


class PagedClientStore:
    """Host-resident per-client pages and a device gather/scatter window.

    ``layout``: ``"csr"`` keeps the capacity-bounded (M, rcap) values /
    indices pair of the CSR wires, ``"dense"`` dense (M, n) rows (the
    ``dense_masked`` wire's residual), ``"none"`` no residual pages at all
    (error feedback off; the counters and byte accounting remain).

    ``paged_dir``: when set, the page arrays are ``.npy`` memory maps under
    that directory instead of anonymous memory, for fleets whose touched
    pages outgrow RAM (``np.zeros`` pages are committed lazily, so
    untouched pages cost nothing either way).

    ``device``: where gathered windows are placed, the card by default.

    ``seconds``: host seconds spent draining the write queue
    (``drain_s``: waits for the device-to-host copies, host scatters) and
    gathering windows (``window_s``: host gathers, enqueuing the copies).
    """

    def __init__(self, M, n, rcap, *, layout="csr", paged_dir=None,
                 device="cuda"):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, "
                             f"got {layout!r}")
        self.M = int(M)
        self.n = int(n)
        self.rcap = int(rcap)
        self.layout = layout
        self.device = torch.device(device)
        self.paged_dir = os.fspath(paged_dir) if paged_dir is not None \
            else None
        if layout == "csr":
            self.res_vals = self._alloc("res_vals", (M, rcap), np.float32)
            self.res_idx = self._alloc("res_idx", (M, rcap), np.int32)
            self._pages = (self.res_vals, self.res_idx)
        elif layout == "dense":
            self.res_rows = self._alloc("res_rows", (M, n), np.float32)
            self._pages = (self.res_rows,)
        else:
            self._pages = ()
        # a page is readable only while valid: retire() clears the bit and
        # the page reads as zero, with no O(M) host write
        self.valid = np.zeros(M, bool)
        self.part_count = np.zeros(M, np.int64)
        self.last_round = np.full(M, -1, np.int64)
        self._queue = []            # ordered ("scatter", ids, arrays) /
                                    # ("retire", ids), drained on gather
        self._window_bytes = 0      # device bytes of the last window
        self._versions = ()         # adopted VersionedBaseStore arrays
        self.seconds = {"drain_s": 0.0, "window_s": 0.0}

    def _alloc(self, name, shape, dtype):
        if self.paged_dir is None:
            return np.zeros(shape, dtype)
        os.makedirs(self.paged_dir, exist_ok=True)
        path = os.path.join(self.paged_dir, f"{name}.npy")
        return np.lib.format.open_memmap(path, mode="w+", shape=shape,
                                         dtype=dtype)

    def adopt_versions(self, *arrays):
        """Reference the host-side per-client version arrays that the
        versioned base store owns, so that :meth:`host_bytes` counts
        them."""
        self._versions = arrays

    # -- deferred write queue ----------------------------------------------
    def _scatter(self, ids, arrays):
        if len(ids):
            host, event = _stage_to_host(arrays)
            self._queue.append(("scatter", np.asarray(ids, np.int64),
                                arrays, host, event))

    def scatter_csr(self, ids, vals, idx):
        """Queue updated (K, rcap) CSR residual pages for ``ids``. Device
        tensors stay referenced until the queue drains; their copies to
        the host start now."""
        self._scatter(ids, (vals, idx))

    def scatter_dense(self, ids, rows):
        """Queue updated dense (K, n) residual rows for ``ids``."""
        self._scatter(ids, (rows,))

    def retire(self, ids):
        """Queue the invalidation of ``ids``' pages (forced restarts): their
        residual mass was accumulated against a base they no longer hold.
        Ordered after any scatter of the same round."""
        if len(ids):
            self._queue.append(("retire", np.asarray(ids, np.int64)))

    def flush(self):
        """Drain the write queue into the host pages, in order."""
        t = time.perf_counter()
        for op in self._queue:
            if op[0] == "scatter":
                _, rows, _, host, event = op
                if event is not None:
                    event.synchronize()
                for dst, src in zip(self._pages, host):
                    dst[rows] = _host(src)
                self.valid[rows] = True
            else:
                self.valid[op[1]] = False
        self._queue = []
        self.seconds["drain_s"] += time.perf_counter() - t

    # -- gather windows -----------------------------------------------------
    def _gather(self, ids):
        self.flush()
        t = time.perf_counter()
        rows = np.asarray(ids, np.int64)
        good = self.valid[rows]
        # only valid pages are read: an invalid one reads as zeros, and
        # reading a never-written page of a lazily committed (or
        # memory-mapped) store would commit (or load) its memory
        out = tuple(take_to_device(page, rows, self.device, good)
                    for page in self._pages)
        self._window_bytes = int(sum(w.nbytes for w in out))
        self.seconds["window_s"] += time.perf_counter() - t
        return out

    def gather_csr(self, ids):
        """(len(ids), rcap) (values, indices) window on the device. Invalid
        (retired or never-written) pages read as zeros, which decode to the
        zero residual row."""
        return self._gather(ids)

    def gather_dense(self, ids):
        """(len(ids), n) dense residual window on the device."""
        return self._gather(ids)[0]

    # -- counters -----------------------------------------------------------
    def record_participation(self, ids, round_no):
        """Count this round's uploaders; ``last_round`` makes a client's
        staleness ``round - last_round`` a host lookup."""
        if len(ids):
            rows = np.asarray(ids, np.int64)
            self.part_count[rows] += 1
            self.last_round[rows] = int(round_no)

    # -- checkpoint / restore ----------------------------------------------
    def state_dict(self):
        """Snapshot the paged state: the queue drains first (and memmap
        pages are flushed to their files), then only the VALID pages are
        kept, so a fleet where most clients never took part snapshots at
        O(touched), not O(M * page)."""
        self.flush()
        for p in self._pages:
            if isinstance(p, np.memmap):
                p.flush()
        ids = np.nonzero(self.valid)[0].astype(np.int64)
        return {"M": self.M, "n": self.n, "rcap": self.rcap,
                "layout": self.layout,
                "ids": ids,
                "pages": [np.ascontiguousarray(p[ids])
                          for p in self._pages],
                "part_count": self.part_count.copy(),
                "last_round": self.last_round.copy()}

    def load_state_dict(self, d):
        """Restore :meth:`state_dict` output onto a store of the same
        geometry. Pages not in the snapshot are invalidated (they read as
        zero)."""
        for k in ("M", "n", "rcap"):
            if int(d[k]) != getattr(self, k):
                raise ValueError(f"paged-store state has {k}={d[k]}, this "
                                 f"store has {k}={getattr(self, k)}")
        if d["layout"] != self.layout:
            raise ValueError(f"paged-store state has layout "
                             f"{d['layout']!r}, this store has "
                             f"{self.layout!r}")
        self._queue = []
        self.valid[:] = False
        ids = np.asarray(d["ids"], np.int64)
        for dst, src in zip(self._pages, d["pages"]):
            dst[ids] = np.asarray(src).reshape((ids.size,) + dst.shape[1:])
        self.valid[ids] = True
        self.part_count[:] = np.asarray(d["part_count"],
                                        np.int64).reshape(self.M)
        self.last_round[:] = np.asarray(d["last_round"],
                                        np.int64).reshape(self.M)
        self._window_bytes = 0

    # -- inspection ---------------------------------------------------------
    def residual_row(self, i):
        """Client ``i``'s dense (n,) host residual (drains the queue
        first): zeros for a retired or never-written page, a CSR page
        decoded by scatter-add (duplicate columns add)."""
        self.flush()
        out = np.zeros(self.n, np.float32)
        if self.layout == "none" or not self.valid[i]:
            return out
        if self.layout == "dense":
            out[:] = self.res_rows[i]
            return out
        np.add.at(out, self.res_idx[i], self.res_vals[i])
        return out

    # -- byte accounting ----------------------------------------------------
    def device_window_bytes(self):
        """Device bytes of per-client state now: the last gather window
        plus the queued pages not yet drained, O(K * page), flat in M."""
        pending = sum(int(a.nbytes) for op in self._queue if op[0] ==
                      "scatter" for a in op[2])
        return self._window_bytes + pending

    def host_bytes(self):
        """Nominal host bytes of the whole per-client store: residual
        pages, validity bits, counters and the adopted version arrays
        (nominal: ``np.zeros`` pages are committed lazily and memmap pages
        live on disk)."""
        total = sum(int(p.nbytes) for p in self._pages)
        total += int(self.valid.nbytes + self.part_count.nbytes
                     + self.last_round.nbytes)
        total += sum(int(np.asarray(v).nbytes) for v in self._versions)
        return total

    def residual_store_bytes(self):
        """Nominal bytes of the residual pages alone (0 without EF)."""
        return sum(int(p.nbytes) for p in self._pages)
