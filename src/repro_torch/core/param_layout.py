"""The chunked parameter axis (§IV-F at real-model scale). Port of
``repro/core/param_layout.py``.

Every engine flattens a client's parameters to one vector of length N
(``sparse_comm.flatten_tree``: sorted leaf names) and stacks the round's
K participants as (K, N). :class:`ParamLayout` partitions ``[0, N)`` into
contiguous chunks **aligned to leaf boundaries**, so the upload encode,
the server blend and the ring advance can go one chunk at a time: the
round's delta temporaries are O(K * max_chunk), not O(K * N).

Leaf alignment gives per-layer sparsity: a chunk never spans two leaves
with different keep-fraction overrides, so the per-row quantile
thresholds of a chunk are per-layer thresholds (a small, sensitive output
head can keep more than the wide dense layer).

A layout of one chunk with no overrides (``is_flat``) is the flat path:
the trainer maps it to no layout at all.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.tree import leaves_with_path, path_name

__all__ = ["ParamLayout", "leaf_sizes"]


def leaf_sizes(template):
    """``[(name, size), ...]`` of a parameter tree (nested dicts and lists
    of tensors) in the flat vector's order (``tree.leaves``, as
    ``flatten_tree``); the names are the reference's leaf path names (keys
    and indices joined by ``/``)."""
    return [(path_name(path), int(math.prod(leaf.shape)))
            for path, leaf in leaves_with_path(template)]


def _match_override(name, overrides):
    """The first override whose pattern is a substring of the leaf name,
    as ``(keep_frac, residual_frac)``. A value may be a float (keep_frac),
    a ``(keep_frac, residual_frac)`` pair or a dict with ``keep_frac`` /
    ``residual_frac`` keys."""
    if not overrides:
        return (None, None)
    for pat, val in overrides.items():
        if pat in name:
            if isinstance(val, dict):
                return (val.get("keep_frac"), val.get("residual_frac"))
            if isinstance(val, (tuple, list)):
                return (val[0], val[1] if len(val) > 1 else None)
            return (float(val), None)
    return (None, None)


@dataclass(frozen=True)
class ParamLayout:
    """An immutable partition of the flat parameter axis ``[0, n)``.

    ``bounds``: contiguous half-open ``(start, end)`` chunk spans covering
    ``[0, n)``. ``keep_frac`` / ``residual_frac``: one entry a chunk,
    ``None`` for the channel's default.
    """

    n: int
    bounds: tuple
    keep_frac: tuple = ()
    residual_frac: tuple = ()
    names: tuple = field(default=(), compare=False)

    def __post_init__(self):
        if not self.bounds:
            raise ValueError("ParamLayout needs at least one chunk")
        pos = 0
        for s, e in self.bounds:
            if s != pos or e <= s:
                raise ValueError(
                    f"chunk bounds must be contiguous and non-empty; got "
                    f"({s}, {e}) at offset {pos}")
            pos = e
        if pos != self.n:
            raise ValueError(f"chunks cover [0, {pos}) but n={self.n}")
        c = len(self.bounds)
        if not self.keep_frac:
            object.__setattr__(self, "keep_frac", (None,) * c)
        if not self.residual_frac:
            object.__setattr__(self, "residual_frac", (None,) * c)
        if len(self.keep_frac) != c or len(self.residual_frac) != c:
            raise ValueError("per-chunk frac tuples must match num_chunks")

    @property
    def num_chunks(self):
        return len(self.bounds)

    @property
    def sizes(self):
        return tuple(e - s for s, e in self.bounds)

    @property
    def max_chunk(self):
        return max(self.sizes)

    @property
    def is_flat(self):
        """One chunk and no overrides: the flat path."""
        return (self.num_chunks == 1
                and self.keep_frac[0] is None
                and self.residual_frac[0] is None)

    @staticmethod
    def flat(n):
        return ParamLayout(n=int(n), bounds=((0, int(n)),))

    @classmethod
    def from_template(cls, template, chunk_size, *, overrides=None):
        """Leaf-aligned chunks of a parameter dict: consecutive leaves with
        the same (possibly absent) override are packed greedily into
        chunks of at most ``chunk_size`` parameters; a leaf larger than
        ``chunk_size`` is split on its own, its last piece ragged."""
        chunk_size = int(chunk_size)
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        bounds, keeps, residuals, names = [], [], [], []
        cur_start, cur_end, cur_ov, cur_names = None, None, None, []

        def close():
            nonlocal cur_start
            if cur_start is not None:
                bounds.append((cur_start, cur_end))
                keeps.append(cur_ov[0])
                residuals.append(cur_ov[1])
                names.append("+".join(cur_names))
                cur_start = None

        offset = 0
        for name, size in leaf_sizes(template):
            ov = _match_override(name, overrides)
            if size > chunk_size:
                close()
                for s in range(offset, offset + size, chunk_size):
                    bounds.append((s, min(s + chunk_size, offset + size)))
                    keeps.append(ov[0])
                    residuals.append(ov[1])
                    names.append(name)
            elif (cur_start is not None and ov == cur_ov
                  and cur_end - cur_start + size <= chunk_size):
                cur_end += size
                cur_names.append(name)
            else:
                close()
                cur_start, cur_end, cur_ov = offset, offset + size, ov
                cur_names = [name]
            offset += size
        close()
        return cls(n=offset, bounds=tuple(bounds), keep_frac=tuple(keeps),
                   residual_frac=tuple(residuals), names=tuple(names))

    def describe(self):
        return {
            "n": self.n,
            "num_chunks": self.num_chunks,
            "max_chunk": self.max_chunk,
            "min_chunk": min(self.sizes),
            "overridden_chunks": sum(
                1 for k, r in zip(self.keep_frac, self.residual_frac)
                if k is not None or r is not None),
        }

    def __repr__(self):
        return (f"ParamLayout(n={self.n}, num_chunks={self.num_chunks}, "
                f"max_chunk={self.max_chunk})")
