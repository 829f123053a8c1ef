"""Sparse-difference transmission (§IV-F) on the compacted CSR wire, with
deferred ACO accounting. Port of the main-path subset of
``repro/core/sparse_comm.py``.

A message is ``delta = new - base``, thresholded per row at the
``1 - keep_frac`` quantile of a strided 2k sample of ``|delta|``, and
compacted by the ``csr_compact`` kernel into (values f32, indices int32)
rows of static capacity ``cap = min(N, ceil(2.5 * keep_frac * N))``; the
receiver's reconstruction scatters that payload back to dense. Bytes on
the wire are the stored elements at 4 + 4 bytes plus a ``4 * (rows + 1)``
row_ptr per batch; ACO is payload
bytes over dense bytes. Counts stay on the device until ``aco`` /
``payload_bytes`` / ``wire_breakdown`` read them, in one transfer.

Still to port: the quantized ``csr_q`` and ``dense_masked`` wires, the
error-feedback residual, chunked layouts and wire validation.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops as kops

QUANTILE_SAMPLE = 2048
CAP_FACTOR = 2.5          # payload capacity slack over the target keep_frac


def tree_sub(a, b):
    return {k: a[k] - b[k] for k in a}


def tree_add(a, b):
    return {k: a[k] + b[k] for k in a}


def flatten_tree(tree):
    """{name: tensor} -> (N,) f32 in sorted-name order, the reference's
    tree-leaves order (conv1_b, conv1_w, ..., out_w): the CSR column
    indices mean the same parameter in both packages."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in sorted(tree)])


def unflatten_like(flat, tree):
    out, idx = {}, 0
    for k in sorted(tree):
        n = tree[k].numel()
        out[k] = flat[idx:idx + n].reshape(tree[k].shape).to(tree[k].dtype)
        idx += n
    return out


def _sampled_quantile(x, q):
    """Per-row linear-interpolation quantile q of ``x`` (K, n) >= 0.

    Written out rather than ``torch.quantile`` so that it rounds as the
    reference does: the position ``q * (n - 1)`` and its weights in
    float32, and the blend ``low * lw + high * hw`` with the first
    product unrounded (the reference backend contracts it into a fused
    multiply-add), here by summing in float64."""
    s = torch.sort(x.to(torch.float32), dim=1).values
    n = s.shape[1]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo))
    lw = np.float32(1.0) - hw
    low = s[:, lo].to(torch.float64) * float(lw)
    high = s[:, hi] * float(hw)
    return (low + high.to(torch.float64)).to(torch.float32)


def csr_decode(values, indices, stored, n):
    """The receiver's scatter of CSR rows (values, indices) (K, cap) with
    ``stored`` (K,) live slots each back to dense (K, n) f32. Padding slots
    all land in one spare column that is cut off, so no live column is
    written twice and the scatter needs no atomics."""
    K, cap = values.shape
    live = torch.arange(cap, device=values.device)[None] < stored[:, None]
    cols = torch.where(live, indices.long(), n)
    out = torch.zeros((K, n + 1), dtype=torch.float32, device=values.device)
    return out.scatter_(1, cols, values)[:, :n]


def local_quantile_thresholds(x, keep_frac, *, sample=QUANTILE_SAMPLE):
    """(K,) per-row |.|-quantile thresholds from a strided ``sample``-point
    subsample: row k keeps roughly its top ``keep_frac`` by magnitude."""
    stride = max(x.shape[1] // sample, 1)
    return _sampled_quantile(x[:, ::stride].abs(), 1.0 - keep_frac)


class SparseComm:
    """Comm channel with deferred ACO bookkeeping, CSR wire only.

    ``threshold``: ``"p<frac>"`` keeps the top <frac> by magnitude per row
    (``"p0.2"`` is the paper's setting); a float is an absolute magnitude
    threshold (capacity N). ``capacity`` pins the per-row payload capacity.
    """

    def __init__(self, threshold="p0.2", *, capacity=None,
                 cap_factor=CAP_FACTOR):
        self.threshold = threshold
        self.capacity = capacity
        self.cap_factor = cap_factor
        self._values_host = 0.0
        self._indices_host = 0.0
        self._pending_payload = []      # (stored count on device, vb, ib)
        self.dense_bytes = 0
        self.row_ptr_bytes = 0
        self.messages = 0

    def elem_bytes(self):
        """(value_bytes, index_bytes) per stored element: f32 + int32."""
        return 4, 4

    def _quantile_frac(self):
        if isinstance(self.threshold, str) and self.threshold.startswith("p"):
            return float(self.threshold[1:])
        return None

    def payload_capacity(self, n):
        """Static per-row payload capacity for an n-param message."""
        if self.capacity is not None:
            return max(1, min(int(self.capacity), n))
        frac = self._quantile_frac()
        if frac is None:                 # absolute threshold: nnz unbounded
            return n
        return max(1, min(n, int(math.ceil(self.cap_factor * frac * n))))

    def _row_thresholds(self, delta):
        frac = self._quantile_frac()
        if frac is not None:
            return local_quantile_thresholds(delta, frac)
        return torch.full((delta.shape[0],), float(self.threshold),
                          dtype=torch.float32, device=delta.device)

    def csr_core(self, new_flat, base_flat):
        """The CSR encode pipeline on (K, n) flat stacks (the reference's
        ``csr_core(False)``): ``(new, base) -> ((values, indices), stored,
        decoded)`` with ``stored = min(nnz, cap)`` the on-wire count per row
        and ``decoded`` the receiver's dense reconstruction, scattered from
        the payload. Per-row only; the caller books the stored counts."""
        n = new_flat.shape[1]
        delta = (new_flat - base_flat).contiguous()
        thr = self._row_thresholds(delta)
        cap = self.payload_capacity(n)
        vals, idx, nnz = kops.csr_compact(delta, thr, cap)
        stored = torch.clamp(nnz, max=cap)
        return (vals, idx), stored, csr_decode(vals, idx, stored, n)

    def encode(self, new_params, base_params):
        """One message ``new - base`` -> (sparse delta tree, stats); booked
        at once. ``stats["nnz"]`` is the stored count as a device scalar."""
        delta = tree_sub(new_params, base_params)
        flat = flatten_tree(delta)
        n = flat.shape[0]
        _, stored, decoded = self.csr_core(flat[None],
                                           torch.zeros_like(flat)[None])
        stats = {"nnz": stored[0], "total": n, "rows": 1}
        self.account_batch_csr(stats["nnz"], n, 1)
        return unflatten_like(decoded[0], delta), stats

    def apply(self, base_params, sparse_delta_tree):
        return tree_add(base_params, sparse_delta_tree)

    # -- deferred accounting -----------------------------------------------
    def account_batch_csr(self, stored_nnz, params_per_message, n_messages):
        """Book an n_messages-row CSR batch whose stored counts are on the
        device: one value + one index per stored element, one shared
        row_ptr. No host sync."""
        vb, ib = self.elem_bytes()
        self._pending_payload.append((torch.sum(stored_nnz), vb, ib))
        self.row_ptr_bytes += 4 * (n_messages + 1)
        self.dense_bytes += params_per_message * n_messages * 4
        self.messages += n_messages

    def account_payload(self, stored_total_dev, params_per_message,
                        n_messages, *, row_ptr_rows=0):
        """Book ``n_messages`` CSR messages whose total stored element count
        is one device scalar (the base store's broadcast); ``row_ptr_rows``
        adds the ``4 * (rows + 1)`` row_ptr framing."""
        vb, ib = self.elem_bytes()
        self._pending_payload.append((stored_total_dev, vb, ib))
        if row_ptr_rows:
            self.row_ptr_bytes += 4 * (row_ptr_rows + 1)
        self.dense_bytes += params_per_message * n_messages * 4
        self.messages += n_messages

    def _materialize(self):
        if self._pending_payload:
            counts = torch.stack([c.reshape(()).to(torch.float64)
                                  for c, _, _ in self._pending_payload])
            for cnt, (_, vb, ib) in zip(counts.cpu().tolist(),
                                        self._pending_payload):
                self._values_host += cnt * vb
                self._indices_host += cnt * ib
            self._pending_payload = []

    @property
    def payload_bytes(self) -> float:
        self._materialize()
        return self._values_host + self._indices_host + self.row_ptr_bytes

    @property
    def aco(self) -> float:
        return self.payload_bytes / self.dense_bytes if self.dense_bytes \
            else 0.0

    def wire_breakdown(self):
        """Cumulative bytes on the wire by component (the reference's keys;
        the csr_q and dense components are zero on this wire)."""
        self._materialize()
        return {"values_bytes": self._values_host,
                "indices_bytes": self._indices_host,
                "scales_bytes": 0.0,
                "row_ptr_bytes": float(self.row_ptr_bytes),
                "dense_payload_bytes": 0.0,
                "payload_bytes": self.payload_bytes,
                "layout": {"num_chunks": 1}}
