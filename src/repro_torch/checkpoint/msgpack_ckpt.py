"""Minimal msgpack tree leaf round-trip, in the reference's file layout.
Port of ``repro/checkpoint/msgpack_ckpt.py``.

Layout: one msgpack map ``{"leaves": [...]}`` where each leaf is
``{"dtype", "shape", "data" (raw bytes)}`` or ``{"py": scalar}``, leaves in
``jax.tree.leaves`` order (``repro_torch.tree``; a None is no leaf, as in
JAX). A bf16 tensor travels as its raw 2-byte words under the dtype name
``"bfloat16"``. The tree's structure is not stored: ``load_checkpoint``
restores into the structure of a caller-provided ``like`` tree and checks
the leaf count, shapes and dtypes against it. Files written here load
with the reference's ``load_checkpoint`` and the other way round.

The msgpack format is written and read here with ``struct`` (the subset
the layout uses: map, array, str, bin, int, float, bool, nil), encoding
each value as msgpack's own packer does.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# msgpack, the subset the layout uses
# ---------------------------------------------------------------------------
def _pack(obj, out):
    """Append ``obj``'s msgpack encoding to the list of byte strings
    ``out`` (payload bytes are appended as they are, not copied)."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(int(obj)))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        out.append(struct.pack("B", 0xa0 | n) if n <= 31 else
                   _head(n, 0xd9, 0xda, 0xdb))
        out.append(b)
    elif isinstance(obj, bytes):
        out.append(_head(len(obj), 0xc4, 0xc5, 0xc6))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(struct.pack("B", 0x90 | n) if n <= 15 else
                   _head(n, None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        out.append(struct.pack("B", 0x80 | n) if n <= 15 else
                   _head(n, None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _head(n, b8, b16, b32):
    """A length header: 8-, 16- or 32-bit, the shortest there is."""
    if b8 is not None and n <= 0xff:
        return struct.pack(">BB", b8, n)
    if n <= 0xffff:
        return struct.pack(">BH", b16, n)
    if n <= 0xffffffff:
        return struct.pack(">BI", b32, n)
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _pack_int(v):
    if 0 <= v < 0x80:
        return struct.pack("B", v)
    if -0x20 <= v < 0:
        return struct.pack("b", v)
    if 0 <= v <= 0xff:
        return struct.pack(">BB", 0xcc, v)
    if -0x80 <= v < 0:
        return struct.pack(">Bb", 0xd0, v)
    if 0 <= v <= 0xffff:
        return struct.pack(">BH", 0xcd, v)
    if -0x8000 <= v < 0:
        return struct.pack(">Bh", 0xd1, v)
    if 0 <= v <= 0xffffffff:
        return struct.pack(">BI", 0xce, v)
    if -0x80000000 <= v < 0:
        return struct.pack(">Bi", 0xd2, v)
    if 0 <= v <= 0xffffffffffffffff:
        return struct.pack(">BQ", 0xcf, v)
    if -0x8000000000000000 <= v < 0:
        return struct.pack(">Bq", 0xd3, v)
    raise OverflowError(f"msgpack cannot hold the integer {v}")


# first byte -> struct format of a fixed-size value
_FIXED = {0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# first byte -> (kind, struct format of its length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def _unpack(buf, i=0):
    """(value, next offset) of the msgpack value at ``buf[i]``."""
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8f:
        return _unpack_map(buf, i, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _unpack_array(buf, i, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if b == 0xc0:
        return None, i
    if b in (0xc2, 0xc3):
        return b == 0xc3, i
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if kind == "bin":
            return buf[i:i + n], i + n
        if kind == "str":
            return bytes(buf[i:i + n]).decode("utf-8"), i + n
        if kind == "array":
            return _unpack_array(buf, i, n)
        return _unpack_map(buf, i, n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {i - 1}")


def _unpack_array(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------
def _leaves(tree):
    """``jax.tree.leaves`` order; None is an empty subtree, not a leaf."""
    return [leaf for leaf in tree_leaves(tree) if leaf is not None]


def _dtype_name(x):
    """A tensor's or array's dtype by the reference's (numpy's) name."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.dtype(x.dtype))


def _pack_leaf(x):
    if isinstance(x, (int, float, bool, str)) or x is None:
        return {"py": x}
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        data = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
            .numpy().tobytes()
        return {"dtype": _dtype_name(t), "shape": list(t.shape),
                "data": data}
    arr = np.asarray(x)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _tensor(d):
    """A stored array leaf as a CPU tensor."""
    if d["dtype"] == "bfloat16":
        words = np.frombuffer(d["data"], dtype=np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16) \
            .reshape(d["shape"])
    arr = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
    return torch.from_numpy(arr.reshape(d["shape"]).copy())


def _array(d):
    """A stored array leaf as numpy (a CPU tensor where numpy has no such
    dtype: bf16 without the ``ml_dtypes`` types registered)."""
    try:
        dtype = np.dtype(d["dtype"])
    except TypeError:
        return _tensor(d)
    return np.frombuffer(d["data"], dtype=dtype).reshape(d["shape"]).copy()


def save_checkpoint(path, tree):
    """Write ``tree``'s leaves (tensors, numpy arrays, Python scalars) to
    ``path``: first to ``path + ".tmp"``, then moved over ``path``."""
    payload = {"leaves": [_pack_leaf(leaf) for leaf in _leaves(tree)]}
    chunks = []
    _pack(payload, chunks)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.writelines(chunks)
    os.replace(tmp, path)


def load_checkpoint(path, like, *, cast=False):
    """Restore into the structure of ``like`` (its structure is the source
    of truth).

    Leaf count and shapes must match ``like`` exactly. Dtypes must match
    too: a checkpoint written as f32 silently reloaded as f16 (or int)
    would corrupt training without a trace, so a mismatch raises unless
    the caller opts in with ``cast=True`` (an explicit, lossy decision).
    A leaf loads as a tensor on the device (and with ``cast`` the dtype)
    of ``like``'s leaf where that is a tensor, as numpy otherwise, and a
    stored Python scalar as it is.
    """
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    payload, _ = _unpack(buf)
    stored = payload["leaves"]
    leaves_like = _leaves(like)
    if len(stored) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves, expected "
            f"{len(leaves_like)}")
    out = []
    for d, want in zip(stored, leaves_like):
        if "py" in d:
            got = d["py"]
        elif isinstance(want, torch.Tensor):
            got = _tensor(d)
        else:
            got = _array(d)
        shape = () if "py" in d else tuple(d["shape"])
        if hasattr(want, "shape") and shape != tuple(want.shape):
            raise ValueError(f"shape mismatch {shape} vs {tuple(want.shape)}")
        if hasattr(want, "dtype") and "py" not in d \
                and d["dtype"] != _dtype_name(want):
            if not cast:
                raise ValueError(
                    f"dtype mismatch: checkpoint leaf is {d['dtype']}, "
                    f"expected {_dtype_name(want)} — pass cast=True to "
                    f"convert explicitly")
            got = got.to(want.dtype) if isinstance(got, torch.Tensor) and \
                isinstance(want, torch.Tensor) else _cast_array(got, want)
        if isinstance(want, torch.Tensor) and isinstance(got, torch.Tensor):
            got = got.to(want.device)
        out.append(got)
    it = iter(out)
    return tree_map(lambda leaf: None if leaf is None else next(it), like)


def _cast_array(got, want):
    """``got`` (numpy, or a bf16 CPU tensor) cast to numpy ``want``'s
    dtype."""
    if isinstance(got, torch.Tensor):
        got = got.to(torch.float32).numpy()
    return got.astype(want.dtype)
