"""Sparse-difference transmission (§IV-F) with deferred ACO accounting.
Port of ``repro/core/sparse_comm.py`` for the ``csr`` and ``dense_masked``
wires and the disabled channel.

A message is ``delta = new - base``, thresholded per row at the
``1 - keep_frac`` quantile of a strided 2k sample of ``|delta|`` (or at an
absolute magnitude). Wires (``wire_format=``):

* ``"csr"`` (default): the ``csr_compact`` kernel packs the survivors
  ``(|delta| >= thr) & (delta != 0)`` into (values f32, indices int32)
  rows of static capacity ``cap = min(N, ceil(2.5 * keep_frac * N))``;
  the receiver scatters that payload back to dense. Bytes on the wire are
  the stored elements at 4 + 4 bytes plus a ``4 * (rows + 1)`` row_ptr
  per batch.
* ``"dense_masked"``: the ``sparse_delta`` kernel keeps ``|delta| >= thr``
  (exact zeros too when ``thr <= 0``) and counts the survivors; the masked
  dense delta moves between the engine's stages, and each survivor books
  4 + 4 bytes, with no row_ptr.
* ``enabled=False``: the dense delta moves as it is and books ``4 * N``
  bytes per message as a dense payload.

ACO is payload bytes over dense bytes. Survivor counts stay on the device
until ``aco`` / ``payload_bytes`` / ``wire_breakdown`` read them, in one
transfer.

Still to port: the quantized ``csr_q`` wire, the error-feedback residual,
chunked layouts and wire validation.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import local_quantile_thresholds

CAP_FACTOR = 2.5          # payload capacity slack over the target keep_frac
WIRE_FORMATS = ("csr", "dense_masked")


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


def flatten_stacked(tree):
    """{name: (K, ...)} with a leading client axis -> (K, N) f32; row i is
    ``flatten_tree`` of client i's parameters."""
    K = next(iter(tree.values())).shape[0]
    return torch.cat([tree[k].reshape(K, -1).to(torch.float32)
                      for k in sorted(tree)], dim=1)


def unflatten_stacked(flat, template):
    """(K, N) flat stack -> {name: (K, ...)} views. ``template`` is one
    client's tree (tensors, possibly on the meta device) giving the
    shapes."""
    K, out, idx = flat.shape[0], {}, 0
    for k in sorted(template):
        n = math.prod(template[k].shape)
        out[k] = flat[:, idx:idx + n].reshape((K,) + tuple(template[k].shape))
        idx += n
    return out


def csr_columns(indices, stored, n):
    """(K, cap) scatter columns of CSR rows with ``stored`` (K,) live
    slots: a live slot's own column, padding slot j the spare column
    ``n + j``. Every column of a row is then distinct, so a scatter into
    ``n + cap`` columns writes each address once, with no collisions (and
    no contention on one spare column), and cutting ``[:n]`` drops the
    padding."""
    cap = indices.shape[1]
    slot = torch.arange(cap, device=indices.device)
    return torch.where(slot[None] < stored[:, None], indices.long(),
                       n + slot[None])


def csr_decode(values, indices, stored, n):
    """The receiver's scatter of CSR rows (values, indices) (K, cap) with
    ``stored`` (K,) live slots each back to dense (K, n) f32, with no
    atomics (``csr_columns``)."""
    K, cap = values.shape
    out = torch.zeros((K, n + cap), dtype=torch.float32, device=values.device)
    return out.scatter_(1, csr_columns(indices, stored, n), values)[:, :n]


class SparseComm:
    """Comm channel with deferred ACO bookkeeping.

    ``threshold``: ``"p<frac>"`` keeps the top <frac> by magnitude per row
    (``"p0.2"`` is the paper's setting); a float is an absolute magnitude
    threshold (CSR capacity N). ``capacity`` pins the per-row CSR payload
    capacity. ``enabled=False`` sends every message dense.
    """

    def __init__(self, threshold="p0.2", *, enabled=True, wire_format="csr",
                 capacity=None, cap_factor=CAP_FACTOR):
        if wire_format not in WIRE_FORMATS:
            raise ValueError(f"wire_format must be one of {WIRE_FORMATS}, "
                             f"got {wire_format!r}")
        self.threshold = threshold
        self.enabled = enabled
        self.wire_format = wire_format
        self.capacity = capacity
        self.cap_factor = cap_factor
        self._values_host = 0.0
        self._indices_host = 0.0
        self._dense_payload_host = 0.0   # disabled-channel dense payloads
        self._pending_payload = []      # (survivor count on device, vb, ib)
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

    def _row_thresholds(self, delta, *, fused="low"):
        """(K,) thresholds; ``fused="high"`` rounds a quantile as the
        reference's one-message encode does (``ref.sampled_quantile``)."""
        frac = self._quantile_frac()
        if frac is not None:
            return local_quantile_thresholds(delta, frac, fused=fused)
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

    def batch_core(self, new_flat, base_flat):
        """The ``dense_masked`` encode pipeline on (K, n) flat stacks (the
        reference's ``batch_core(False)``): ``(new, base) -> (masked (K, n),
        nnz (K,))``, one ``sparse_delta`` launch with per-row thresholds.
        The caller books ``nnz`` (``account_batch``)."""
        delta = (new_flat - base_flat).contiguous()
        frac = self._quantile_frac()
        if frac is not None:
            masked, blocks, _ = kops.sparse_delta_topfrac(delta, frac)
        else:
            masked, blocks = kops.sparse_delta_batch(
                delta, self._row_thresholds(delta))
        return masked, blocks.sum(dim=1)

    def encode(self, new_params, base_params):
        """One message ``new - base`` -> (sparse delta tree, stats); booked
        at once. ``stats["nnz"]`` is the stored (csr) or surviving
        (dense_masked) count as a device scalar, N when disabled."""
        delta = tree_sub(new_params, base_params)
        flat = flatten_tree(delta)
        n = flat.shape[0]
        if not self.enabled:
            self.account_batch(None, n, 1)
            return delta, {"nnz": n, "total": n, "rows": 1}
        if self.wire_format == "csr":
            _, stored, decoded = self.csr_core(flat[None],
                                               torch.zeros_like(flat)[None])
            stats = {"nnz": stored[0], "total": n, "rows": 1}
            self.account_batch_csr(stats["nnz"], n, 1)
            return unflatten_like(decoded[0], delta), stats
        thr = self._row_thresholds(flat[None], fused="high")
        masked, blocks = kops.sparse_delta(flat, thr)
        stats = {"nnz": blocks.sum(), "total": n, "rows": 1}
        self._account(stats["nnz"], n, 1)
        return unflatten_like(masked, delta), stats

    def encode_batch(self, new_flat, base_flat):
        """K messages at once from (K, n) flat stacks -> (the receiver's
        dense deltas (K, n), stats with the per-row (K,) count); booked at
        once. Disabled: the dense delta, count n per row."""
        K, n = new_flat.shape
        if not self.enabled:
            self.account_batch(None, n, K)
            return new_flat - base_flat, {
                "nnz": torch.full((K,), n, device=new_flat.device),
                "total": n, "rows": K}
        if self.wire_format == "csr":
            _, stored, decoded = self.csr_core(new_flat, base_flat)
            self.account_batch_csr(stored, n, K)
            return decoded, {"nnz": stored, "total": n, "rows": K}
        masked, nnz = self.batch_core(new_flat, base_flat)
        self.account_batch(nnz, n, K)
        return masked, {"nnz": nnz, "total": n, "rows": K}

    def apply(self, base_params, sparse_delta_tree):
        return tree_add(base_params, sparse_delta_tree)

    # -- deferred accounting -----------------------------------------------
    def account_batch(self, nnz, params_per_message, n_messages):
        """Book n_messages dense_masked messages whose survivor counts are
        the device vector ``nnz`` (ignored on a disabled channel, where
        every message is a dense payload). No host sync."""
        if not self.enabled:
            self._dense_payload_host += n_messages * params_per_message * 4
            self.dense_bytes += n_messages * params_per_message * 4
            self.messages += n_messages
            return
        self._account(torch.sum(nnz), params_per_message * n_messages,
                      n_messages)

    def _account(self, nnz_dev, total_params, n_messages):
        # dense_masked: f32 value + int32 index per survivor, no row_ptr
        self._pending_payload.append((nnz_dev, 4, 4))
        self.dense_bytes += total_params * 4
        self.messages += n_messages

    def account_batch_csr(self, stored_nnz, params_per_message, n_messages):
        """Book an n_messages-row CSR batch whose stored counts are on the
        device: one value + one index per stored element, one shared
        row_ptr. No host sync."""
        if not self.enabled:
            self.account_batch(stored_nnz, params_per_message, n_messages)
            return
        vb, ib = self.elem_bytes()
        self._pending_payload.append((torch.sum(stored_nnz), vb, ib))
        self.row_ptr_bytes += 4 * (n_messages + 1)
        self.dense_bytes += params_per_message * n_messages * 4
        self.messages += n_messages

    def account_payload(self, stored_total_dev, params_per_message,
                        n_messages, *, row_ptr_rows=0):
        """Book ``n_messages`` messages whose total stored element count is
        one device scalar (the base store's broadcast); ``row_ptr_rows``
        adds the ``4 * (rows + 1)`` CSR row_ptr framing."""
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
        return self._values_host + self._indices_host + \
            self._dense_payload_host + self.row_ptr_bytes

    @property
    def aco(self) -> float:
        return self.payload_bytes / self.dense_bytes if self.dense_bytes \
            else 0.0

    def wire_breakdown(self):
        """Cumulative bytes on the wire by component (the reference's keys;
        the csr_q scale component is zero on these wires)."""
        self._materialize()
        return {"values_bytes": self._values_host,
                "indices_bytes": self._indices_host,
                "scales_bytes": 0.0,
                "row_ptr_bytes": float(self.row_ptr_bytes),
                "dense_payload_bytes": self._dense_payload_host,
                "payload_bytes": self.payload_bytes,
                "layout": {"num_chunks": 1}}
