"""Sparse-difference transmission (§IV-F) with deferred ACO accounting and
error feedback. Port of ``repro/core/sparse_comm.py`` for the ``csr``,
``csr_q`` and ``dense_masked`` wires and the disabled channel.

A message is ``delta = new - base`` (plus the sender's error-feedback
residual, when EF is on), thresholded per row at the ``1 - keep_frac``
quantile of a strided 2k sample of ``|delta|`` (or at an absolute
magnitude). Wires (``wire_format=``):

* ``"csr"`` (default): the ``csr_compact`` kernel packs the survivors
  ``(|delta| >= thr) & (delta != 0)`` into (values f32, indices int32)
  rows of static capacity ``cap = min(N, ceil(2.5 * keep_frac * N))``;
  the receiver scatters that payload back to dense. Bytes on the wire are
  the stored elements at 4 + 4 bytes plus a ``4 * (rows + 1)`` row_ptr
  per batch.
* ``"csr_q"``: the same payload through the ``csr_quant`` kernel: int8
  values with a per-row absmax scale (``q_dtype="fp16"``: float16 values,
  no scale shipped) and int16 in-block column offsets with a per-row
  ``ceil(N/512)``-entry int16 block-count table: 1 + 2 bytes per stored
  element (fp16: 2 + 2), plus 4 bytes of scale and ``2 * ceil(N/512)``
  of table per row. Everything downstream (the receiver's decode, the
  chain, the EF residual) is computed from the dequantized payload, so
  the rounding error joins the residual.
* ``"dense_masked"``: the ``sparse_delta`` kernel keeps ``|delta| >= thr``
  (exact zeros too when ``thr <= 0``) and counts the survivors; the masked
  dense delta moves between the engine's stages, and each survivor books
  4 + 4 bytes, with no row_ptr.
* ``enabled=False``: the dense delta moves as it is and books ``4 * N``
  bytes per message as a dense payload.

Error feedback: the part of ``delta`` the receiver does not get back is
the sender's new residual, re-offered with the next message. On the CSR
wires it is ``delta - decoded`` truncated to its top ``residual_frac`` of
N by magnitude (a per-row sampled quantile, then ``csr_compact`` at
``residual_capacity``); on ``dense_masked`` it is ``delta - masked``; a
disabled channel sends everything and keeps a zero residual.

Under the paged client store a CSR-wire residual lives as a (rcap,) page
(values, indices) on the host; ``encode_paged`` takes one and returns the
new one, bit for bit what ``encode`` gives with the page's dense expansion
as the residual.

Chunked parameter axis (``layout=``, a ``core.param_layout.ParamLayout``):
the CSR wires encode a full-model message one leaf-aligned chunk at a time
(``chunk_encode_body``, ``chunk_advance_body``), each chunk at its own
width, capacity and keep fraction, through the same kernels; a message
then carries one row_ptr, and on csr_q one scale and one block table, a
chunk. EF residual pages are the concatenation of the chunks' pages and
hold global columns.

ACO is payload bytes over dense bytes. Survivor counts stay on the device
until ``aco`` / ``payload_bytes`` / ``wire_breakdown`` read them, in one
transfer.

Wire integrity (the fault layer): ``validate_payload`` checks an upload's
delivery stats at the trust boundary and raises ``WireIntegrityError`` on
any malformation; ``malform_stats`` damages a nominal payload in one of
the ``MALFORM_KINDS`` ways, which is how the trainer materializes a
corrupt-fated upload before quarantining it. Both run on the host, on
numpy (a torch tensor is copied to the host first). ``ledger_state`` /
``load_ledger_state`` carry the byte ledgers through a fleet checkpoint.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (csr_dequantize_ref,
                                     csr_unpack_indices_ref,
                                     local_quantile_thresholds)
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map

CAP_FACTOR = 2.5          # payload capacity slack over the target keep_frac
RESIDUAL_FRAC = 0.25      # EF residual: top fraction of N kept by magnitude
WIRE_FORMATS = ("csr", "csr_q", "dense_masked")
CSR_FORMATS = ("csr", "csr_q")
Q_DTYPES = tuple(kops.Q_DTYPES)      # csr_q value types: "int8", "fp16"
Q_BLOCK = 512             # csr_q offsets lie in [0, Q_BLOCK); one block
                          # count per Q_BLOCK columns
# the fault injector's malformed-payload menu: every class of corruption the
# wire validator must catch, each raising WireIntegrityError on either CSR
# wire (``SparseComm.malform_stats``)
MALFORM_KINDS = ("row_ptr", "oob_index", "nan_value", "bad_scale",
                 "arity", "truncated", "dtype")


class WireIntegrityError(ValueError):
    """An incoming upload failed wire validation (malformed row_ptr,
    out-of-bounds index, non-finite value or scale, wrong arity, dtype or
    shape, truncated buffer). The payload is quarantined: never decoded,
    never aggregated, never booked."""


def _np(a):
    """A payload array as numpy (a torch tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def flatten_tree(tree):
    """A parameter tree -> (N,) f32 in the reference's tree-leaves order
    (``tree.leaves``: dict keys sorted at every level, lists in order; the
    CNN's conv1_b, conv1_w, ..., out_w): the CSR column indices mean the
    same parameter in both packages."""
    return torch.cat([leaf.reshape(-1).to(torch.float32)
                      for leaf in tree_leaves(tree)])


def unflatten_like(flat, tree):
    """(N,) flat vector -> ``tree``'s structure, shapes and dtypes (views
    of ``flat`` where the dtype is float32)."""
    idx = 0

    def take(leaf):
        nonlocal idx
        n = leaf.numel()
        out = flat[idx:idx + n].reshape(leaf.shape).to(leaf.dtype)
        idx += n
        return out
    return tree_map(take, tree)


def flatten_stacked(tree):
    """A tree of (K, ...) leaves with a leading client axis -> (K, N) f32;
    row i is ``flatten_tree`` of client i's parameters."""
    lv = tree_leaves(tree)
    K = lv[0].shape[0]
    return torch.cat([leaf.reshape(K, -1).to(torch.float32) for leaf in lv],
                     dim=1)


def unflatten_stacked(flat, template):
    """(K, N) flat stack -> ``template``'s structure with (K, ...) views.
    ``template`` is one client's tree (tensors, possibly on the meta
    device) giving the shapes."""
    K, idx = flat.shape[0], 0

    def take(leaf):
        nonlocal idx
        n = math.prod(leaf.shape)
        out = flat[:, idx:idx + n].reshape((K,) + tuple(leaf.shape))
        idx += n
        return out
    return tree_map(take, template)


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


def _scatter_decode(values, indices, stored, n):
    """Dense (K, n) f32 of (K, cap) rows ``values`` at ``indices``, one
    row at a time through an (n + cap,) scratch row: the int64 columns and
    the spare columns of one row are alive at a time, not of all K (at a
    language model's width six rows' columns alone take 10 GB)."""
    K, cap = values.shape
    out = torch.empty((K, n), dtype=torch.float32, device=values.device)
    row = torch.empty(n + cap, dtype=torch.float32, device=values.device)
    for k in range(K):
        row.zero_()
        row.scatter_(0, csr_columns(indices[k:k + 1], stored[k:k + 1],
                                    n)[0], values[k])
        out[k] = row[:n]
    return out


def csr_decode(values, indices, stored, n):
    """The receiver's scatter of CSR rows (values, indices) (K, cap) with
    ``stored`` (K,) live slots each back to dense (K, n) f32, with no
    atomics (``csr_columns``)."""
    return _scatter_decode(values, indices, stored, n)


def csr_page_decode(values, indices, n):
    """Dense (K, n) f32 of CSR residual pages (K, rcap), which carry no
    count: ``csr_compact`` keeps only nonzero values, in a prefix of the
    row, and zeroes the slots past it, so a page's live slots are its
    nonzero ones. The resident layout's ``csr_decode`` of the same rows,
    bit for bit; an all-zero page (retired, never written) decodes to
    zeros."""
    return csr_decode(values, indices, torch.count_nonzero(values, dim=1),
                      n)


def csr_q_columns(qoffs, qcnt, stored, n):
    """``csr_columns`` of csr_q rows: absolute columns rebuilt from the
    int16 offsets and the block-count table, as a receiver does."""
    return csr_columns(csr_unpack_indices_ref(qoffs, qcnt), stored, n)


def csr_q_decode(qvals, qoffs, qcnt, scales, stored, n):
    """The receiver's decode of csr_q rows to dense (K, n) f32: columns
    from offsets + block counts, values ``q * scale``."""
    return _scatter_decode(csr_dequantize_ref(qvals, scales),
                           csr_unpack_indices_ref(qoffs, qcnt), stored, n)


class SparseComm:
    """Comm channel with deferred ACO bookkeeping.

    ``threshold``: ``"p<frac>"`` keeps the top <frac> by magnitude per row
    (``"p0.2"`` is the paper's setting); a float is an absolute magnitude
    threshold (CSR capacity N). ``capacity`` pins the per-row CSR payload
    capacity. ``enabled=False`` sends every message dense.
    ``residual_frac``: the EF residual's share of N on the CSR wires.
    ``q_dtype``: the csr_q value type, ``"int8"`` or ``"fp16"``.
    ``layout``: a ``ParamLayout`` for the chunked encode (``chunk_plan``)
    and the per-chunk framing of full-model messages, or None.

    A tau-forced restart discards the client's residual with its
    trajectory (the trainer zeroes it): it was accumulated against a base
    the client no longer holds.
    """

    def __init__(self, threshold="p0.2", *, enabled=True, wire_format="csr",
                 capacity=None, cap_factor=CAP_FACTOR,
                 residual_frac=RESIDUAL_FRAC, q_dtype="int8", layout=None):
        if wire_format not in WIRE_FORMATS:
            raise ValueError(f"wire_format must be one of {WIRE_FORMATS}, "
                             f"got {wire_format!r}")
        if q_dtype not in Q_DTYPES:
            raise ValueError(f"q_dtype must be one of {Q_DTYPES}, "
                             f"got {q_dtype!r}")
        self.threshold = threshold
        self.layout = layout            # ParamLayout | None
        self._chunk_plan = None
        # encode ("upload" / "chain") -> (per-chunk stored counts on the
        # device, message rows): ``chunk_stored_share``
        self._chunk_counts = {}
        self.enabled = enabled
        self.wire_format = wire_format
        self.capacity = capacity
        self.cap_factor = cap_factor
        self.residual_frac = residual_frac
        self.q_dtype = q_dtype
        self._values_host = 0.0
        self._indices_host = 0.0
        self._dense_payload_host = 0.0   # disabled-channel dense payloads
        self._pending_payload = []      # (survivor count on device, vb, ib)
        self.dense_bytes = 0
        self.row_ptr_bytes = 0
        self.scales_bytes = 0           # csr_q per-row scales
        self.block_table_bytes = 0      # csr_q per-row block-count tables
        self.messages = 0

    def elem_bytes(self):
        """(value_bytes, index_bytes) per stored element: f32 + int32, or
        on csr_q int8 (fp16) + an int16 offset."""
        if self.wire_format == "csr_q":
            return (2, 2) if self.q_dtype == "fp16" else (1, 2)
        return 4, 4

    def row_overhead_bytes(self, n):
        """(scale_bytes, block_table_bytes) of one n-parameter csr_q row:
        the f32 scale (none in fp16 mode, whose scales are all ones) and
        the int16 block-count table; zero on the other wires. A
        full-model message under a chunked layout carries one scale and
        one table a chunk."""
        if self.wire_format != "csr_q":
            return 0, 0
        scale = 0 if self.q_dtype == "fp16" else 4
        chunks = self._layout_chunks(n)
        if chunks > 1:
            table = sum(2 * max((nc + Q_BLOCK - 1) // Q_BLOCK, 1)
                        for nc in self.layout.sizes)
            return scale * chunks, table
        return scale, 2 * max((n + Q_BLOCK - 1) // Q_BLOCK, 1)

    def _layout_chunks(self, n):
        """Chunks an n-parameter message spans: the layout's for a
        full-model message (n == layout.n), else 1."""
        if self.layout is not None and n == self.layout.n:
            return self.layout.num_chunks
        return 1

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

    def residual_capacity(self, n):
        """Static per-row capacity of the EF residual."""
        return max(1, min(n, int(math.ceil(self.residual_frac * n))))

    def _row_thresholds(self, delta, *, fused="low"):
        """(K,) thresholds; ``fused="high"`` rounds a quantile as the
        reference's one-message encode does (``ref.sampled_quantile``)."""
        frac = self._quantile_frac()
        if frac is not None:
            return local_quantile_thresholds(delta, frac, fused=fused)
        return torch.full((delta.shape[0],), float(self.threshold),
                          dtype=torch.float32, device=delta.device)

    def _compact(self, delta, thresholds, cap):
        """(K, n) deltas and (K,) thresholds -> (wire payload, stored) at
        capacity ``cap``: the payload is (values, indices) on csr and
        (qvals, offsets, block_counts, scales) on csr_q."""
        vals, idx, nnz = kops.csr_compact(delta, thresholds, cap)
        stored = torch.clamp(nnz, max=cap)
        if self.wire_format != "csr_q":
            return (vals, idx), stored
        return kops.csr_quantize(vals, idx, stored, delta.shape[1],
                                 q_dtype=self.q_dtype), stored

    def _decode(self, payload, stored, n):
        """The receiver's dense (K, n) decode of a payload, dequantized on
        csr_q."""
        if self.wire_format != "csr_q":
            return csr_decode(*payload, stored, n)
        return csr_q_decode(*payload, stored, n)

    def _encode_payload(self, delta, thresholds, cap):
        """``_compact`` and the receiver's ``_decode``: (wire payload,
        stored, decoded)."""
        payload, stored = self._compact(delta, thresholds, cap)
        return payload, stored, self._decode(payload, stored,
                                             delta.shape[1])

    def csr_core(self, new_flat, base_flat, residual_flat=None, *,
                 pages=False):
        """The CSR-family encode pipeline on (K, n) flat stacks (the
        reference's ``csr_core``): ``(new, base[, residual]) -> (payload,
        stored, decoded[, residual'])`` with ``stored = min(nnz, cap)`` the
        on-wire count per row and ``decoded`` the receiver's dense decode.
        With a residual, the message is ``new - base + residual`` and
        ``residual'`` (K, n) is ``message - decoded`` (sub-threshold mass,
        capacity overflow and, on csr_q, rounding error) cut to its top
        ``residual_frac`` per row at ``residual_capacity``; with
        ``pages=True`` it is that cut as (values, indices) (K, rcap) pages
        instead, undecoded. Per-row only; the caller books the stored
        counts."""
        delta = new_flat - base_flat
        if residual_flat is not None:
            delta = delta + residual_flat
        delta = delta.contiguous()
        n = delta.shape[1]
        thr = self._row_thresholds(delta)
        if residual_flat is None:
            # the decode needs only the payload: the (K, n) delta goes
            # first (at a language model's width six rows take 10 GB)
            payload, stored = self._compact(delta, thr,
                                            self.payload_capacity(n))
            del delta
            return payload, stored, self._decode(payload, stored, n)
        payload, stored, decoded = self._encode_payload(
            delta, thr, self.payload_capacity(n))
        res = (delta - decoded).contiguous()
        rcap = self.residual_capacity(n)
        rvals, ridx, rnnz = kops.csr_compact(
            res, local_quantile_thresholds(res, self.residual_frac), rcap)
        if pages:
            return payload, stored, decoded, (rvals, ridx)
        res = csr_decode(rvals, ridx, torch.clamp(rnnz, max=rcap), n)
        return payload, stored, decoded, res

    def batch_core(self, new_flat, base_flat, residual_flat=None):
        """The ``dense_masked`` encode pipeline on (K, n) flat stacks (the
        reference's ``batch_core``): ``(new, base[, residual]) -> (masked
        (K, n), nnz (K,)[, residual'])``, one ``sparse_delta`` launch with
        per-row thresholds; ``residual' = message - masked``, untruncated.
        The caller books ``nnz`` (``account_batch``)."""
        delta = new_flat - base_flat
        if residual_flat is not None:
            delta = delta + residual_flat
        delta = delta.contiguous()
        frac = self._quantile_frac()
        if frac is not None:
            masked, blocks, _ = kops.sparse_delta_topfrac(delta, frac)
        else:
            masked, blocks = kops.sparse_delta_batch(
                delta, self._row_thresholds(delta))
        if residual_flat is None:
            return masked, blocks.sum(dim=1)
        return masked, blocks.sum(dim=1), delta - masked

    def distribute_core(self, new_flat, dist_base):
        """The dense base store's distribution encode (the reference's
        ``_distribute_encode_body``): the new global model (n,) against the
        (T, n) stack of the targets' base rows, one message a row, through
        one call of each of the wire's kernels: ``(new base rows (T, n),
        counts (T,))``. On the CSR wires a new base row is the old one plus
        the (on csr_q dequantized) decode of its payload and the count is
        the stored one; on dense_masked the old row plus the masked delta,
        counting its survivors. Disabled, every new row is the model itself
        (``base + (g - base)`` would re-round), count n. The caller books
        the counts."""
        T, n = dist_base.shape
        g = new_flat.expand(T, n)
        if not self.enabled:
            return g.clone(), torch.full((T,), n, device=new_flat.device)
        if self.wire_format in CSR_FORMATS:
            _, stored, decoded = self.csr_core(g, dist_base)
            return dist_base + decoded, stored
        masked, nnz = self.batch_core(g, dist_base)
        return dist_base + masked, nnz

    def encode(self, new_params, base_params, residual=None):
        """One message ``new - base`` (+ ``residual``, a tree, under EF) ->
        (sparse delta tree, stats[, residual' tree]); booked at once.
        ``stats["nnz"]`` is the stored (CSR wires) or surviving
        (dense_masked) count as a device scalar, N when disabled."""
        delta = tree_sub(new_params, base_params)
        if residual is not None:
            delta = tree_add(delta, residual)
        flat = flatten_tree(delta)
        n = flat.shape[0]
        if not self.enabled:
            self.account_batch(None, n, 1)
            out = delta, {"nnz": n, "total": n, "rows": 1}
            if residual is None:
                return out
            return out + (tree_map(torch.zeros_like, delta),)
        if self.wire_format in CSR_FORMATS:
            zero = torch.zeros_like(flat)[None]
            out = self.csr_core(flat[None], zero,
                                None if residual is None else zero)
            stats = {"nnz": out[1][0], "total": n, "rows": 1}
            self.account_batch_csr(stats["nnz"], n, 1)
            return (unflatten_like(out[2][0], delta), stats) + tuple(
                unflatten_like(r[0], delta) for r in out[3:])
        thr = self._row_thresholds(flat[None], fused="high")
        masked, blocks = kops.sparse_delta(flat, thr)
        stats = {"nnz": blocks.sum(), "total": n, "rows": 1}
        self._account(stats["nnz"], n, 1)
        out = unflatten_like(masked, delta), stats
        if residual is None:
            return out
        return out + (unflatten_like(flat - masked, delta),)

    def encode_paged(self, new_params, base_params, res_vals, res_idx):
        """One CSR-wire message against a PAGED residual
        (``sparse_comm.py:1015-1041``): the client's residual arrives as a
        (rcap,) page (values, indices) and the new one leaves as a page
        for the store's write queue. Returns ``(sparse delta tree, stats,
        (rvals', ridx'))``; booked at once. The page decodes to exactly
        the dense row the resident layout keeps, and adding it to the flat
        delta is the elementwise sum ``encode`` forms leaf by leaf, so the
        result is ``encode``'s with that row as the residual, bit for
        bit."""
        delta = tree_sub(new_params, base_params)
        flat = flatten_tree(delta)
        n = flat.shape[0]
        flat = flat + csr_page_decode(res_vals[None], res_idx[None], n)[0]
        zero = torch.zeros_like(flat)[None]
        _, stored, decoded, (rvals, ridx) = self.csr_core(
            flat[None], zero, zero, pages=True)
        stats = {"nnz": stored[0], "total": n, "rows": 1}
        self.account_batch_csr(stats["nnz"], n, 1)
        return unflatten_like(decoded[0], delta), stats, (rvals[0], ridx[0])

    def encode_batch(self, new_flat, base_flat, residual_flat=None):
        """K messages at once from (K, n) flat stacks -> (the receiver's
        dense deltas (K, n), stats with the per-row (K,) count[, residual'
        (K, n)]); booked at once. Disabled: the dense delta, count n per
        row, a zero residual."""
        K, n = new_flat.shape
        if not self.enabled:
            self.account_batch(None, n, K)
            delta = new_flat - base_flat
            if residual_flat is not None:
                delta = delta + residual_flat
            out = delta, {"nnz": torch.full((K,), n, device=new_flat.device),
                          "total": n, "rows": K}
            if residual_flat is None:
                return out
            return out + (torch.zeros_like(delta),)
        if self.wire_format in CSR_FORMATS:
            _, stored, decoded, *res = self.csr_core(new_flat, base_flat,
                                                     residual_flat)
            self.account_batch_csr(stored, n, K)
            return (decoded, {"nnz": stored, "total": n, "rows": K}, *res)
        masked, nnz, *res = self.batch_core(new_flat, base_flat,
                                            residual_flat)
        self.account_batch(nnz, n, K)
        return (masked, {"nnz": nnz, "total": n, "rows": K}, *res)

    # -- chunked parameter axis (core.param_layout) ------------------------
    def chunk_plan(self):
        """The layout's per-chunk encode plan: a list of dicts ``{s, e, nc,
        keep, cap, rfrac, rcap, roff}``: ``keep`` the chunk's keep-fraction
        override (None: the channel's threshold), ``cap`` its payload
        capacity at its width, ``rfrac`` / ``rcap`` its EF residual share
        and capacity, ``[roff, roff + rcap)`` its segment of a client's
        concatenated residual page."""
        if self._chunk_plan is not None:
            return self._chunk_plan
        if self.layout is None:
            raise ValueError("chunk_plan() requires a layout "
                             "(SparseComm(layout=...))")
        default_frac = self._quantile_frac()
        plan, roff = [], 0
        for c, (s, e) in enumerate(self.layout.bounds):
            nc = e - s
            keep = self.layout.keep_frac[c]
            frac = keep if keep is not None else default_frac
            if self.capacity is not None:
                cap = max(1, min(int(self.capacity), nc))
            elif frac is None:          # absolute threshold: nnz unbounded
                cap = nc
            else:
                cap = max(1, min(nc, int(math.ceil(self.cap_factor
                                                   * frac * nc))))
            rfrac = self.layout.residual_frac[c]
            rfrac = rfrac if rfrac is not None else self.residual_frac
            rcap = max(1, min(nc, int(math.ceil(rfrac * nc))))
            plan.append({"s": s, "e": e, "nc": nc, "keep": keep, "cap": cap,
                         "rfrac": rfrac, "rcap": rcap, "roff": roff})
            roff += rcap
        self._chunk_plan = plan
        return plan

    def residual_capacity_total(self):
        """Width of a client's concatenated EF residual page under the
        layout: the sum of the chunks' residual capacities."""
        return sum(p["rcap"] for p in self.chunk_plan())

    def _chunk_thresholds(self, delta_c, keep):
        """(K,) per-row thresholds of one chunk: its keep-fraction override
        when it has one, else the channel's rule, both through the per-row
        quantile (``fused="low"``)."""
        if keep is not None:
            return local_quantile_thresholds(delta_c, keep)
        return self._row_thresholds(delta_c)

    def _chunk_encode_one(self, delta_c, plan_c):
        """One chunk's encode: (K, nc) deltas -> (wire payload with
        chunk-local columns, stored (K,), decoded (K, nc)), through the
        same kernels as a flat message at the chunk's width."""
        return self._encode_payload(
            delta_c, self._chunk_thresholds(delta_c, plan_c["keep"]),
            plan_c["cap"])

    def chunk_encode_body(self, with_residual=False):
        """The reference's ``chunk_encode_body``, the loop the trainer's
        upload runs: ``fn(new, base, sink=None) -> (payloads, stored,
        decoded)`` per-chunk lists with chunk-local columns, or with the
        residual ``fn(new, base, rvals, ridx, sink=None) -> (payloads,
        stored, decoded, (rvals', ridx'))`` for (K, rcap_total) EF pages,
        the new ones written a chunk's segment at a time with GLOBAL
        columns. ``base(s, e)`` gives the chunk's (K, e - s) bases (a ring
        gather by slot: no (K, N) base copy); it is read before the
        chunk's decode reaches ``sink``. A chunk's message is ``new -
        base`` plus, with EF, the decode of its page segment; its residual
        is ``message - decoded`` cut to the chunk's top ``rfrac``. With
        ``sink``, each decode goes to ``sink(p, decoded)`` as it is made
        and is not kept (``decoded`` comes back empty): one chunk's delta,
        decode and residual are alive at a time."""
        def body(new, base, *pages, sink=None):
            if bool(pages) != bool(with_residual):
                raise TypeError("residual pages given to the wrong body")
            if pages:
                rvals, ridx = pages
                new_pages = (torch.empty_like(rvals), torch.empty_like(ridx))
            payloads, stored, decodes = [], [], []
            for p in self.chunk_plan():
                s, e, nc = p["s"], p["e"], p["nc"]
                delta = new[:, s:e] - base(s, e)
                if pages:
                    seg = slice(p["roff"], p["roff"] + p["rcap"])
                    # global -> chunk-local columns; zero pads clip to 0
                    local = torch.clamp(ridx[:, seg] - s, 0, nc - 1)
                    delta = delta + csr_page_decode(rvals[:, seg], local, nc)
                delta = delta.contiguous()
                payload, st, decoded = self._chunk_encode_one(delta, p)
                payloads.append(payload)
                stored.append(st)
                if pages:
                    res = (delta - decoded).contiguous()
                    rv, ri, _ = kops.csr_compact(
                        res, local_quantile_thresholds(res, p["rfrac"]),
                        p["rcap"])
                    new_pages[0][:, seg] = rv
                    new_pages[1][:, seg] = ri + s
                    del res, rv, ri
                del delta
                if sink is None:
                    decodes.append(decoded)
                else:
                    sink(p, decoded)
                del decoded
            self._count_chunks("upload", stored, new.shape[0])
            if not pages:
                return payloads, stored, decodes
            return payloads, stored, decodes, new_pages
        return body

    def _count_chunks(self, what, stored, rows):
        """Add one encode's per-chunk stored counts (a list of (rows,)
        tensors) to ``what``'s running totals, on the device."""
        got = torch.stack(stored).sum(1)
        old = self._chunk_counts.get(what)
        self._chunk_counts[what] = (got, rows) if old is None else \
            (old[0] + got, old[1] + rows)

    def chunk_stored_share(self):
        """Per chunk of the layout, the share of its columns the chunked
        encodes stored over every message so far: ``{"upload": [...],
        "chain": [...]}`` (``chunk_encode_body`` / ``chunk_advance_body``;
        one host transfer each)."""
        widths = [p["nc"] for p in self.chunk_plan()]
        return {what: [c / (rows * nc) for c, nc in
                       zip(cnt.cpu().tolist(), widths)]
                for what, (cnt, rows) in self._chunk_counts.items()}

    def chunk_advance_body(self):
        """The ring advance's encode of one (n,) transition ``new - prev``
        chunk by chunk: ``fn(new, prev) -> (recon, chain)`` with ``recon``
        the whole decoded reconstruction and ``chain`` the flat chain
        entry's tuple: ``(vals, idx, stored)`` on csr, the chunks'
        payloads concatenated with global columns, or ``(qvals, offsets,
        block_counts, scales, stored)`` on csr_q with one scale a chunk
        (what the chunked wire ships)."""
        quantized = self.wire_format == "csr_q"

        def body(new_flat, prev_flat):
            recon, parts, stored, each = [], [], 0, []
            for p in self.chunk_plan():
                s, e = p["s"], p["e"]
                delta = (new_flat[s:e] - prev_flat[s:e])[None].contiguous()
                pay, st, dec = self._chunk_encode_one(delta, p)
                recon.append(prev_flat[s:e] + dec[0])
                stored = stored + st[0]
                each.append(st)
                if quantized:
                    parts.append(tuple(x[0] for x in pay))
                else:
                    parts.append((pay[0][0], pay[1][0] + s))
            cat = tuple(torch.cat([q[i] for q in parts]) for i in range(2))
            if quantized:
                chain = cat + (torch.cat([q[2] for q in parts]),
                               torch.stack([q[3] for q in parts]), stored)
            else:
                chain = cat + (stored,)
            self._count_chunks("chain", each, 1)
            return torch.cat(recon), chain
        return body

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

    def _book_rows(self, rows, params_per_message):
        """CSR framing of ``rows`` rows: one shared row_ptr, plus the csr_q
        per-row scales and block-count tables (a row_ptr, scale and table
        a chunk under a chunked layout)."""
        self.row_ptr_bytes += 4 * (rows + 1) * \
            self._layout_chunks(params_per_message)
        sb, bb = self.row_overhead_bytes(params_per_message)
        self.scales_bytes += sb * rows
        self.block_table_bytes += bb * rows

    def account_batch_csr(self, stored_nnz, params_per_message, n_messages):
        """Book an n_messages-row CSR-family batch whose stored counts are
        on the device: one value + one index per stored element at the
        format's widths, and the batch's framing. No host sync."""
        if not self.enabled:
            self.account_batch(stored_nnz, params_per_message, n_messages)
            return
        vb, ib = self.elem_bytes()
        self._pending_payload.append((torch.sum(stored_nnz), vb, ib))
        self._book_rows(n_messages, params_per_message)
        self.dense_bytes += params_per_message * n_messages * 4
        self.messages += n_messages

    def account_payload(self, stored_total_dev, params_per_message,
                        n_messages, *, row_ptr_rows=0):
        """Book ``n_messages`` messages whose total stored element count is
        one device scalar (the base store's broadcast); ``row_ptr_rows``
        adds the CSR framing of that many rows."""
        vb, ib = self.elem_bytes()
        self._pending_payload.append((stored_total_dev, vb, ib))
        if row_ptr_rows:
            self._book_rows(row_ptr_rows, params_per_message)
        self.dense_bytes += params_per_message * n_messages * 4
        self.messages += n_messages

    def account_dense_payload(self, total_bytes, params_per_message,
                              n_messages):
        """Book ``n_messages`` plain dense messages (full-model resync
        unicasts) of ``total_bytes`` in all, straight into the dense
        payload component."""
        self._dense_payload_host += float(total_bytes)
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
            self._dense_payload_host + self.row_ptr_bytes + \
            self.scales_bytes + self.block_table_bytes

    @property
    def aco(self) -> float:
        return self.payload_bytes / self.dense_bytes if self.dense_bytes \
            else 0.0

    def wire_breakdown(self):
        """Cumulative bytes on the wire by component (the reference's keys:
        csr_q block-count tables count as indices); ``layout`` describes
        the chunked parameter axis the framing was booked under."""
        self._materialize()
        layout = {"num_chunks": 1} if self.layout is None else \
            self.layout.describe()
        return {"values_bytes": self._values_host,
                "indices_bytes": self._indices_host + self.block_table_bytes,
                "scales_bytes": float(self.scales_bytes),
                "row_ptr_bytes": float(self.row_ptr_bytes),
                "dense_payload_bytes": self._dense_payload_host,
                "payload_bytes": self.payload_bytes,
                "layout": layout}

    # -- wire integrity ----------------------------------------------------
    def csr_stats(self, payload, stored, n):
        """Delivery stats of a CSR-family payload (the reference's
        ``_csr_stats`` of a stack): ``values`` / ``indices`` are the f32
        values and int32 columns on csr, the quantized values and int16
        offsets on csr_q, which adds ``blocks`` and ``scales``."""
        stats = {"nnz": stored, "total": int(n), "rows": int(len(stored)),
                 "values": payload[0], "indices": payload[1]}
        if self.wire_format == "csr_q":
            stats["blocks"], stats["scales"] = payload[2], payload[3]
        return stats

    def validate_payload(self, stats):
        """Check an incoming upload's delivery stats at the trust boundary,
        before any decode or booking; raise ``WireIntegrityError`` on a
        malformation, else return ``stats`` unchanged (the reference's
        ``validate_payload``, check for check).

        In order: the framing fields; the arity (exactly the arrays this
        wire ships: 2 on csr, 4 on csr_q; a dense-family message has only
        its counts, each in [0, total]); the stored-count vector (one
        integer a row); no truncation (every array spans rows x the shared
        capacity); integer indices and the wire's value dtype; the implied
        row_ptr (counts in [0, capacity]); every live column inside
        ``[0, total)`` (csr_q offsets inside their block); finite live
        values; on csr_q, an integer block-count table that sums to the
        stored counts, and finite scales. Host numpy, syncing by design:
        it runs only on quarantine candidates, never in a round body."""
        def fail(msg):
            raise WireIntegrityError(f"malformed upload: {msg}")

        if not isinstance(stats, dict):
            fail(f"payload is {type(stats).__name__}, not a stats mapping")
        for k in ("nnz", "total", "rows"):
            if k not in stats:
                fail(f"missing framing field {k!r}")
        try:
            rows, n = int(stats["rows"]), int(stats["total"])
        except (TypeError, ValueError):
            fail("non-integer rows/total framing")
        if rows < 1 or n < 1:
            fail(f"non-positive framing (rows={rows}, total={n})")

        quantized = self.wire_format == "csr_q"
        payload_keys = {"values", "indices"} | \
            ({"blocks", "scales"} if quantized else set())
        got = {k for k in ("values", "indices", "blocks", "scales")
               if k in stats}
        if got != payload_keys:
            if not self.enabled or self.wire_format not in CSR_FORMATS:
                stored = _np(stats["nnz"]).astype(np.float64).reshape(-1)
                if not np.isfinite(stored).all() or (stored < 0).any() \
                        or (stored > n).any():
                    fail("dense message count outside [0, total]")
                return stats
            fail(f"wrong payload arity for {self.wire_format!r}: expected "
                 f"fields {sorted(payload_keys)}, got {sorted(got)}")

        vals, idx, stored = (_np(stats[k])
                             for k in ("values", "indices", "nnz"))
        if stored.size != rows:
            fail(f"stored-count vector has {stored.size} entries for "
                 f"{rows} rows")
        if not np.issubdtype(stored.dtype, np.integer):
            fail(f"stored counts must be integers, got {stored.dtype}")
        stored = stored.reshape(-1).astype(np.int64)
        if vals.size == 0 or vals.size % rows or idx.size % rows:
            fail("truncated payload buffer: array size not divisible by "
                 "the row count")
        cap = vals.size // rows
        if idx.size != rows * cap:
            fail(f"truncated payload buffer: values span {cap} "
                 f"columns/row, indices {idx.size // rows}")
        vals, idx = vals.reshape(rows, cap), idx.reshape(rows, cap)
        if not np.issubdtype(idx.dtype, np.integer):
            fail(f"indices must be integers, got {idx.dtype}")
        want = (np.int8 if self.q_dtype == "int8" else np.float16) \
            if quantized else np.float32
        if vals.dtype != np.dtype(want):
            fail(f"values dtype {vals.dtype} != {np.dtype(want)} for wire "
                 f"format {self.wire_format!r}")
        if (stored < 0).any() or (stored > cap).any():
            fail(f"row_ptr not monotone in-capacity: stored counts must "
                 f"lie in [0, {cap}], got "
                 f"[{int(stored.min())}, {int(stored.max())}]")
        live = np.arange(cap)[None, :] < stored[:, None]
        bound = Q_BLOCK if quantized else n
        if ((idx < 0) & live).any() or ((idx >= bound) & live).any():
            fail(f"column {'offset' if quantized else 'index'} out of "
                 f"bounds [0, {bound})")
        if not np.isfinite(vals[live].astype(np.float64)).all():
            fail("non-finite payload value")
        if quantized:
            blocks, scales = _np(stats["blocks"]), _np(stats["scales"])
            if not np.issubdtype(blocks.dtype, np.integer):
                fail(f"block-count table must be integers, got "
                     f"{blocks.dtype}")
            nblocks = blocks.size // rows if blocks.size % rows == 0 else -1
            if nblocks < 1:
                fail("truncated block-count table")
            blocks = blocks.reshape(rows, nblocks).astype(np.int64)
            if (blocks < 0).any():
                fail("negative block count")
            if (blocks.sum(axis=1) != stored).any():
                fail("block-count table inconsistent with stored counts")
            if not np.isfinite(scales.astype(np.float64)).all():
                fail("non-finite quantization scale")
        return stats

    def malform_stats(self, stats, kind):
        """A copy of ``stats`` damaged in one way, ``kind`` of
        ``MALFORM_KINDS`` (the reference's mutilations, one for one): a
        negative count, a live column past the model (csr_q: the block)
        edge, a NaN value (csr_q: an infinite scale), a NaN scale (csr: a
        spurious scale field), a missing index array, a values buffer one
        column short, float indices."""
        if kind not in MALFORM_KINDS:
            raise ValueError(f"kind must be one of {MALFORM_KINDS}, "
                             f"got {kind!r}")
        out = dict(stats)
        quantized = self.wire_format == "csr_q"
        rows = int(out["rows"])
        if kind == "row_ptr":
            stored = _np(out["nnz"]).reshape(-1).copy()
            stored[0] = -1
            out["nnz"] = stored
        elif kind == "oob_index":
            idx = _np(out["indices"]).reshape(rows, -1).copy()
            idx[0, 0] = Q_BLOCK if quantized else int(out["total"])
            stored = _np(out["nnz"]).reshape(-1).copy()
            stored[0] = max(int(stored[0]), 1)   # the bad column is live
            out["indices"], out["nnz"] = idx, stored
        elif kind == "nan_value":
            if quantized:
                scales = _np(out["scales"]).astype(np.float32).reshape(-1)
                scales[0] = np.inf
                out["scales"] = scales
            else:
                vals = _np(out["values"]).astype(np.float32).reshape(rows,
                                                                     -1)
                vals[0, 0] = np.nan
                stored = _np(out["nnz"]).reshape(-1).copy()
                stored[0] = max(int(stored[0]), 1)
                out["values"], out["nnz"] = vals, stored
        elif kind == "bad_scale":
            if quantized:
                scales = _np(out["scales"]).astype(np.float32).reshape(-1)
                scales[0] = np.nan
                out["scales"] = scales
            else:
                out["scales"] = np.ones(rows, np.float32)
        elif kind == "arity":
            del out["indices"]
        elif kind == "truncated":
            vals = _np(out["values"]).reshape(rows, -1)
            out["values"] = vals[:, :-1] if vals.shape[1] > 1 \
                else np.zeros((rows, 0), vals.dtype)
        elif kind == "dtype":
            out["indices"] = _np(out["indices"]).astype(np.float32)
        return out

    # -- checkpoint / restore ----------------------------------------------
    def ledger_state(self, *, defer=False):
        """The cumulative byte ledgers as host numbers. The pending device
        counts are folded first (value-neutral: the fold keeps their
        order). ``defer=True`` (the checkpoint writer's path) does not wait
        for the device: the fold is a ``fleet_ckpt.Lazy`` over the pending
        entries as they stand, resolved on the writer thread with the same
        float64 arithmetic, and the live ledger's pending list is left as
        it is."""
        if defer:
            from repro_torch.core import fleet_ckpt
            vb, ib = float(self._values_host), float(self._indices_host)
            pend = list(self._pending_payload)

            def fold(base, col):
                out = base
                for entry in pend:
                    out += float(entry[0].to(torch.float64).item()) * \
                        entry[col]
                return out

            values = fleet_ckpt.Lazy(lambda: fold(vb, 1))
            indices = fleet_ckpt.Lazy(lambda: fold(ib, 2))
        else:
            self._materialize()
            values = float(self._values_host)
            indices = float(self._indices_host)
        return {"values_host": values, "indices_host": indices,
                "dense_payload_host": float(self._dense_payload_host),
                "dense_bytes": int(self.dense_bytes),
                "row_ptr_bytes": int(self.row_ptr_bytes),
                "scales_bytes": int(self.scales_bytes),
                "block_table_bytes": int(self.block_table_bytes),
                "messages": int(self.messages)}

    def load_ledger_state(self, d):
        """Restore ``ledger_state`` output; pending entries are dropped
        (the checkpoint is the truth)."""
        self._pending_payload = []
        self._values_host = float(d["values_host"])
        self._indices_host = float(d["indices_host"])
        self._dense_payload_host = float(d["dense_payload_host"])
        self.dense_bytes = int(d["dense_bytes"])
        self.row_ptr_bytes = int(d["row_ptr_bytes"])
        self.scales_bytes = int(d["scales_bytes"])
        self.block_table_bytes = int(d["block_table_bytes"])
        self.messages = int(d["messages"])
