"""Reader for the reference's dmlc::Stream NDArray file format.

``mx.nd.save`` in upstream MXNet (``src/ndarray/ndarray.cc``
``NDArray::Save/Load`` + ``MXNDArrayLoad``) writes:

    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  ndarray count                     (dmlc vector header)
    per array:
        uint32  magic: V1 0xF993FAC8 | V2 0xF993FAC9 | V3 0xF993FACA
        int32   storage type                  (V2/V3 only; 0 = dense)
        shape:  uint32 ndim + ndim x uint32   (V1/V2)
                uint32 ndim + ndim x int64    (V3 — int64 tensor size)
        int32   dev_type, int32 dev_id        (Context::Load)
        int32   type_flag                     (mshadow dtype enum)
        raw     little-endian data bytes      (size * dtype itemsize)
    uint64  name count                        (dmlc vector header)
    per name: uint64 length + utf-8 bytes

The port's ``nd.load`` reads this layout, so checkpoints the reference
wrote load directly; ``nd.save`` writes the JAX package's MXTPU001
layout (``ndarray.py``).  Read-only, dense arrays only, as the JAX
package's ``ndarray/legacy_io.py``, of which this is a copy.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

LIST_MAGIC = 0x112
_V1 = 0xF993FAC8
_V2 = 0xF993FAC9
_V3 = 0xF993FACA

# mshadow type_flag enum (mshadow/base.h)
_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16,
               3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64,
               7: np.bool_}


def looks_legacy(head8: bytes) -> bool:
    """True if the first 8 bytes are the dmlc list magic."""
    return len(head8) == 8 and \
        struct.unpack("<Q", head8)[0] == LIST_MAGIC


def _read(f, n, what):
    b = f.read(n)
    if len(b) != n:
        raise MXNetError(
            f"legacy NDArray file truncated while reading {what} "
            f"(wanted {n} bytes, got {len(b)})")
    return b


def _load_one(f):
    (magic,) = struct.unpack("<I", _read(f, 4, "ndarray magic"))
    if magic not in (_V1, _V2, _V3):
        raise MXNetError(
            f"bad NDArray magic 0x{magic:08x} (expected the dmlc "
            "V1/V2/V3 save format)")
    if magic in (_V2, _V3):
        (stype,) = struct.unpack("<i", _read(f, 4, "storage type"))
        if stype != 0:
            raise MXNetError(
                f"legacy load: sparse storage type {stype} is not "
                "supported (dense checkpoints only)")
    (ndim,) = struct.unpack("<I", _read(f, 4, "ndim"))
    if ndim > 32:
        raise MXNetError(f"implausible ndim {ndim} in legacy file")
    dim_fmt, dim_sz = ("<q", 8) if magic == _V3 else ("<I", 4)
    shape = tuple(
        struct.unpack(dim_fmt, _read(f, dim_sz, "shape dim"))[0]
        for _ in range(ndim))
    # Context (dev_type, dev_id) — load always lands on our default ctx
    struct.unpack("<ii", _read(f, 8, "context"))
    (type_flag,) = struct.unpack("<i", _read(f, 4, "type flag"))
    dt = _TYPE_FLAGS.get(type_flag)
    if dt is None:
        raise MXNetError(f"unknown type_flag {type_flag} in legacy "
                         "NDArray file")
    dt = np.dtype(dt)
    n_elem = 1
    for d in shape:
        n_elem *= int(d)
    raw = _read(f, n_elem * dt.itemsize, "tensor data")
    return np.frombuffer(raw, dtype=dt).reshape(shape)


def load_legacy(f):
    """Parse an open binary stream positioned at 0.

    Returns ``(names, arrays)`` — names is ``[]`` when the file was
    saved from a list (empty name vector)."""
    head = struct.unpack("<QQ", _read(f, 16, "file header"))
    if head[0] != LIST_MAGIC:
        raise MXNetError("not a legacy dmlc NDArray file")
    (count,) = struct.unpack("<Q", _read(f, 8, "ndarray count"))
    if count > 1_000_000:
        raise MXNetError(f"implausible ndarray count {count}")
    arrays = [_load_one(f) for _ in range(count)]
    (n_names,) = struct.unpack("<Q", _read(f, 8, "name count"))
    if n_names not in (0, count):
        raise MXNetError(
            f"legacy file has {n_names} names for {count} arrays")
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack("<Q", _read(f, 8, "name length"))
        names.append(_read(f, ln, "name").decode("utf-8"))
    return names, arrays
