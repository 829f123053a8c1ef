"""Crash-consistent fleet checkpoints: atomic, checksummed, restartable.
The protocol of ``repro/core/fleet_ckpt.py`` with an encoding of its own.

One checkpoint is a directory ``<root>/ckpt-{round:08d}/`` holding one
section file per state owner (trainer tensors and RNG streams, scheduler
heaps, base-store ring, comm ledgers, paged client pages, round logs) and
a ``MANIFEST`` carrying a sha256 digest of every section and the
trainer's configuration fingerprint. Write protocol:

1. section files are written directly (no per-file fsync or rename):
   until the manifest lands the directory is uncommitted, and the
   manifest's digests make a section that was torn mid-write or never
   reached the disk indistinguishable from bit rot, so restore detects
   it instead of trusting it;
2. the MANIFEST is written LAST, by tmp + fsync + rename: the single
   commit and durability point. A crash at any earlier moment leaves a
   directory with no manifest, or one whose digests do not match the
   files; a power cut at worst invalidates the newest checkpoint, which
   restore skips;
3. retention prunes all but the newest ``keep`` checkpoints: the previous
   good one survives so that a torn newest write has a fallback.

:func:`find_restorable` scans the checkpoints newest first and returns the
first whose manifest parses and whose every section matches its digest.

Encoding (standard library and numpy only): a file is an 8-byte magic, the
8-byte little-endian length of a JSON header, the header, then the raw
bytes of every array back to back. The header is the value's structure:
arrays are ``{"__nd__": [dtype, shape, offset, nbytes]}`` into the byte
region (torch tensors are written as their numpy arrays and read back as
numpy), ``bytes`` are ``{"__bytes__": [offset, nbytes]}``, dicts whose keys
are not all plain strings are ``{"__map__": [[key, value], ...]}``, tuples
read back as lists, and integers of any width (the 128-bit PCG64 state
words of ``np.random.Generator``) and floats (NaN and infinities too) are
JSON numbers that read back exactly. So RNG stream positions, a
``torch.Generator.get_state()`` byte tensor and every array's dtype and
shape restore bit for bit.

The encoding is not the reference's msgpack one: the port's checkpoints
are not readable by the reference, nor the reference's by the port.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np
import torch

MANIFEST_NAME = "MANIFEST"
FORMAT_VERSION = 1
MAGIC = b"RTFCKPT1"
_CKPT_RE = re.compile(r"^ckpt-(\d{8})$")


class Lazy:
    """A value whose host form is computed when it is encoded: ``fn`` is a
    thunk over state that nothing writes after the snapshot (device tensors
    the training thread no longer writes, host numbers copied at the
    snapshot). Lets a snapshot taken on the training thread leave the
    device-to-host copies to the checkpoint writer thread."""
    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn


class PrePacked:
    """A section already encoded (bytes), or a thunk giving them, resolved
    when it is written; :func:`write_checkpoint` stores the bytes as they
    are."""
    __slots__ = ("_src",)

    def __init__(self, src):
        self._src = src

    @property
    def data(self) -> bytes:
        return self._src() if callable(self._src) else self._src


# -- value encoding ---------------------------------------------------------
def _plain_keys(d):
    return all(isinstance(k, str) and not k.startswith("__") for k in d)


def _encode(obj, blobs, offset):
    """``obj`` lowered to JSON types, its arrays appended to ``blobs`` (a
    list of contiguous byte buffers) from byte ``offset[0]`` on."""
    if isinstance(obj, Lazy):
        return _encode(obj.fn(), blobs, offset)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, (bytes, bytearray)):
        ref = [offset[0], len(obj)]
        blobs.append(bytes(obj))
        offset[0] += len(obj)
        return {"__bytes__": ref}
    if isinstance(obj, dict):
        if _plain_keys(obj):
            return {k: _encode(v, blobs, offset) for k, v in obj.items()}
        return {"__map__": [[_encode(k, blobs, offset),
                             _encode(v, blobs, offset)]
                            for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return [_encode(v, blobs, offset) for v in obj]
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    arr = np.asarray(obj)
    if arr.dtype.hasobject:
        raise TypeError(f"cannot encode an object array ({type(obj)})")
    ref = [arr.dtype.str, list(arr.shape), offset[0], int(arr.nbytes)]
    arr = np.ascontiguousarray(arr)      # (0-d arrays come back 1-d)
    blobs.append(memoryview(arr.reshape(-1)).cast("B"))
    offset[0] += int(arr.nbytes)
    return {"__nd__": ref}


def _frame(header: bytes):
    return MAGIC + len(header).to_bytes(8, "little") + header


def pack_parts(obj):
    """``obj`` encoded as a list of byte buffers whose concatenation is
    :func:`pack` ``(obj)``; the arrays' buffers are not copied."""
    blobs, offset = [], [0]
    tree = _encode(obj, blobs, offset)
    header = json.dumps(tree, separators=(",", ":")).encode()
    return [_frame(header)] + blobs


def pack(obj) -> bytes:
    return b"".join(pack_parts(obj))


def pack_element(obj) -> bytes:
    """The JSON text of an array-free value, for
    :func:`pack_array_of_packed`."""
    blobs, offset = [], [0]
    tree = _encode(obj, blobs, offset)
    if blobs:
        raise ValueError("pack_element takes values without arrays or "
                         "bytes")
    return json.dumps(tree, separators=(",", ":")).encode()


def pack_array_of_packed(items):
    """A list assembled from :func:`pack_element` texts, which
    :func:`unpack` reads as the list of those values: an append-only
    history (the round logs) is then encoded once an element over a run,
    not once a checkpoint."""
    return _frame(b"[" + b",".join(items) + b"]")


def _decode(obj, blob):
    if isinstance(obj, dict):
        if len(obj) == 1:
            (tag, val), = obj.items()
            if tag == "__nd__":
                dtype, shape, off, nbytes = val
                dt = np.dtype(dtype)
                if off < 0 or off + nbytes > len(blob) or \
                        nbytes != dt.itemsize * int(np.prod(shape)):
                    raise ValueError("array outside the byte region")
                return np.frombuffer(blob, dt, nbytes // dt.itemsize,
                                     off).reshape(tuple(shape)).copy()
            if tag == "__bytes__":
                off, nbytes = val
                if off < 0 or off + nbytes > len(blob):
                    raise ValueError("bytes outside the byte region")
                return bytes(blob[off:off + nbytes])
            if tag == "__map__":
                return {_key(_decode(k, blob)): _decode(v, blob)
                        for k, v in val}
        return {k: _decode(v, blob) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, blob) for v in obj]
    return obj


def _key(k):
    return tuple(k) if isinstance(k, list) else k


def unpack(data):
    """The value :func:`pack` encoded. Raises ``ValueError`` on a buffer
    that is not one (wrong magic, torn header or byte region)."""
    data = memoryview(data)
    if len(data) < 16 or bytes(data[:8]) != MAGIC:
        raise ValueError("not a fleet checkpoint file (bad magic)")
    hlen = int.from_bytes(data[8:16], "little")
    if 16 + hlen > len(data):
        raise ValueError("torn checkpoint file (header cut short)")
    tree = json.loads(bytes(data[16:16 + hlen]).decode())
    return _decode(tree, data[16 + hlen:])


# -- atomic file protocol ---------------------------------------------------
def _write_atomic(path, data: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def checkpoint_dirs(root):
    """Every checkpoint directory under ``root`` as (round, path), by
    round; none when ``root`` does not exist yet."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    out = [(int(m.group(1)), os.path.join(root, name))
           for name in names for m in [_CKPT_RE.match(name)] if m]
    return sorted(out)


def write_checkpoint(root, round_no, sections, fingerprint, *, keep=2):
    """Write one checkpoint; returns its directory. ``sections`` maps a
    section name to its state (or a :class:`PrePacked`). The MANIFEST
    (digests, ``fingerprint``, ``round``) commits the write; retention then
    drops all but the newest ``keep`` checkpoints."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"ckpt-{int(round_no):08d}")
    os.makedirs(path, exist_ok=True)
    files = {}
    for name, obj in sections.items():
        parts = [obj.data] if isinstance(obj, PrePacked) else pack_parts(obj)
        h = hashlib.sha256()
        fname = f"{name}.ckpt"
        # a plain write: the digest catches a torn section, and the
        # fsynced manifest is the commit point
        with open(os.path.join(path, fname), "wb") as f:
            for part in parts:
                f.write(part)
                h.update(part)
        files[fname] = h.hexdigest()
    manifest = {"format": FORMAT_VERSION, "round": int(round_no),
                "files": files, "fingerprint": fingerprint}
    _write_atomic(os.path.join(path, MANIFEST_NAME), pack(manifest))
    for _, old in checkpoint_dirs(root)[:-max(int(keep), 1)]:
        shutil.rmtree(old, ignore_errors=True)
    return path


def validate_checkpoint(path):
    """The manifest if the checkpoint at ``path`` is complete and every
    section matches its digest; None for a torn, corrupt or uncommitted
    one."""
    try:
        with open(os.path.join(path, MANIFEST_NAME), "rb") as f:
            manifest = unpack(f.read())
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or \
            not isinstance(manifest.get("files"), dict):
        return None
    for fname, digest in manifest["files"].items():
        h = hashlib.sha256()
        try:
            with open(os.path.join(path, fname), "rb") as f:
                for block in iter(lambda: f.read(1 << 24), b""):
                    h.update(block)
        except OSError:
            return None
        if h.hexdigest() != digest:
            return None
    return manifest


def find_restorable(root):
    """The newest valid checkpoint under ``root`` as (path, manifest), or
    (None, None): a torn newest write falls back to the one before."""
    for _, path in reversed(checkpoint_dirs(root)):
        manifest = validate_checkpoint(path)
        if manifest is not None:
            return path, manifest
    return None, None


def read_section(path, name):
    """One section of a checkpoint directory."""
    with open(os.path.join(path, f"{name}.ckpt"), "rb") as f:
        return unpack(f.read())
