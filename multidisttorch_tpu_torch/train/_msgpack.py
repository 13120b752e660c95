"""The msgpack subset of flax's v1 checkpoints, with no ``msgpack`` package.

flax writes a checkpoint as ``msgpack.packb(state_dict, default=
_msgpack_ext_pack, strict_types=True)`` (``flax.serialization.
msgpack_serialize``). A VAE train state's state dict holds only:

- maps with string keys (an empty map for optax's ``EmptyState``);
- numpy arrays, as ext type 1: the msgpack array ``(shape, dtype name,
  C-order bytes)``;
- numpy scalars, as ext type 3, the same payload of a 0-d array.

:func:`packb` writes exactly flax's bytes for such a tree and
:func:`unpackb` reads them back. Anything else raises. flax splits an
array of more than ``MAX_CHUNK_SIZE`` bytes into chunks; no VAE leaf is
near that size, and the codec raises on one rather than write a file
that flax could not read.
"""

from __future__ import annotations

import struct

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE
MAX_CHUNK_SIZE = 2**30
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _uint(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    if n <= 0xFF:
        return b"\xcc" + bytes([n])
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _header(n: int, fix: int, fix_max: int, codes: tuple, widths=(">B", ">H", ">I")) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (8-, 16-, 32-bit lengths, or 16- and 32-bit) that fits."""
    if n < fix_max:
        return bytes([fix | n])
    limits = {">B": 0xFF, ">H": 0xFFFF, ">I": 0xFFFFFFFF}
    for code, width in zip(codes, widths):
        if n <= limits[width]:
            return bytes([code]) + struct.pack(width, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + raw


def _bin(b: bytes) -> bytes:
    n = len(b)
    if n <= 0xFF:
        return b"\xc4" + bytes([n]) + b
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n) + b
    return b"\xc6" + struct.pack(">I", n) + b


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code]) + data
    if n <= 0xFF:
        return b"\xc7" + bytes([n, code]) + data
    if n <= 0xFFFF:
        return b"\xc8" + struct.pack(">H", n) + bytes([code]) + data
    return b"\xc9" + struct.pack(">I", n) + bytes([code]) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype.name, bytes))``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
        raise ValueError(
            f"array of {arr.size * arr.dtype.itemsize} bytes exceeds flax's MAX_CHUNK_SIZE "
            f"({MAX_CHUNK_SIZE}); flax would write it in chunks, which this codec does not"
        )
    shape = _header(len(arr.shape), 0x90, 16, (0xDC, 0xDD), (">H", ">I"))
    shape += b"".join(_uint(int(d)) for d in arr.shape)
    return b"\x93" + shape + _str(arr.dtype.name) + _bin(arr.tobytes("C"))


def _pack(x, out: list) -> None:
    if isinstance(x, dict):
        out.append(_header(len(x), 0x80, 16, (0xDE, 0xDF), (">H", ">I")))
        for k, v in x.items():
            if type(k) is not str:
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            out.append(_str(k))
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}: only dicts, ndarrays and numpy scalars")


def packb(tree: dict) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` writes."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, b: int, fix_lo: int, fix_hi: int, codes: dict) -> int:
        if fix_lo <= b <= fix_hi:
            return b - fix_lo
        if b in codes:
            return self.unpack(codes[b])
        raise ValueError(f"unexpected msgpack type byte 0x{b:02x}")

    def obj(self):
        b = self.take(1)[0]
        if 0x80 <= b <= 0x8F or b in (0xDE, 0xDF):
            n = self.length(b, 0x80, 0x8F, {0xDE: ">H", 0xDF: ">I"})
            out = {}
            for _ in range(n):
                key = self.obj()
                if not isinstance(key, str):
                    raise ValueError(f"map key of type {type(key).__name__}, expected str")
                out[key] = self.obj()
            return out
        if 0xA0 <= b <= 0xBF or b in (0xD9, 0xDA, 0xDB):
            n = self.length(b, 0xA0, 0xBF, {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"})
            return str(self.take(n), "utf-8")
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if 0x90 <= b <= 0x9F or b in (0xDC, 0xDD):
            n = self.length(b, 0x90, 0x9F, {0xDC: ">H", 0xDD: ">I"})
            return [self.obj() for _ in range(n)]
        if b < 0x80:
            return b
        if b in (0xCC, 0xCD, 0xCE, 0xCF):
            return self.unpack({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}[b])
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed or b in (0xC7, 0xC8, 0xC9):
            n = fixed[b] if b in fixed else self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.take(1)[0]
            return _ext_value(code, bytes(self.take(n)))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _ext_value(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    r = _Reader(data)
    shape, name, buf = r.obj()
    if r.pos != len(data) or not isinstance(shape, list) or not isinstance(buf, bytes):
        raise ValueError("malformed ndarray payload")
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")
    return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """The tree ``flax.serialization.msgpack_restore(data)`` returns, for
    the subset above. Raises ``ValueError`` on bytes outside it, on a
    chunked array, and on trailing bytes."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after the msgpack object")
    if isinstance(tree, dict) and _has_chunked(tree):
        raise ValueError("chunked array leaves (flax MAX_CHUNK_SIZE) are not supported")
    return tree


def _has_chunked(d: dict) -> bool:
    return "__msgpack_chunked_array__" in d or any(
        isinstance(v, dict) and _has_chunked(v) for v in d.values()
    )
