"""The subset of msgpack that flax's ``serialization.to_bytes`` writes for a
params tree, read and written without the msgpack package.

A params tree is a map of str keys whose values are maps again or arrays.
flax packs each array as msgpack ext type 1 holding a packed 3-array
``(shape, dtype name, C-order bytes)`` (``flax/serialization.py``,
``_ndarray_to_bytes`` / ``_msgpack_ext_pack``), its maps' keys sorted, as
flax's ``jax.tree_util`` pass over the tree leaves them.  The writer here
sorts the keys and picks the encodings msgpack picks (the smallest header
for each length and int), so :func:`dumps` of a tree is byte-equal to
flax's ``msgpack_serialize`` of it.

Anything outside that subset raises: other ext types (flax's numpy scalars
and complex numbers), flax's chunked arrays (``__msgpack_chunked_array__``,
written for arrays over 1 GiB), and values that are neither maps nor
arrays.  A ``bfloat16`` array (numpy has no such dtype) is read as float32,
which holds every bfloat16 value exactly.
"""

from __future__ import annotations

import struct
from typing import Dict, Mapping, Tuple

import numpy as np

_NDARRAY = 1  # flax's _MsgpackExtType.ndarray


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b in (0xC2, 0xC3):  # a chunked array's marker
            return b == 0xC3
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        sizes = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}
        if b in sizes:
            return self.uint(sizes[b])
        lengths = {0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
                   0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
                   0xDC: ("array", 2), 0xDD: ("array", 4),
                   0xDE: ("map", 2), 0xDF: ("map", 4),
                   0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4)}
        if b in lengths:
            kind, width = lengths[b]
            n = self.uint(width)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the subset a "
                         "flax params tree uses")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a string")
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked arrays (leaves over 1 GiB) are not "
                             "supported")
        return out

    def ext(self, n: int) -> np.ndarray:
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code != _NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not a flax ndarray")
        inner = _Reader(payload)
        shape, dtype, buf = inner.value()
        if inner.pos != len(payload) or not isinstance(buf, bytes):
            raise ValueError("malformed flax ndarray payload")
        if dtype == "bfloat16":
            bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def loads(data: bytes) -> Dict:
    """Bytes written by flax's ``to_bytes`` of a params tree (or by
    :func:`dumps`) -> nested dicts of numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after the msgpack tree")
    if not isinstance(tree, dict):
        raise ValueError("a params tree is a map at the top")
    _check_leaves(tree)
    return tree


def _check_leaves(tree: Mapping, path: str = "") -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _check_leaves(value, f"{path}/{key}")
        elif not isinstance(value, np.ndarray):
            raise ValueError(f"{path}/{key}: a params tree holds maps and arrays, "
                             f"not {type(value).__name__}")


def _header(n: int, fix: Tuple[int, int], wide: Tuple[Tuple[int, int], ...]) -> bytes:
    """msgpack's length header: the fix form below ``fix[1]``, else the first
    (type byte, width) whose width holds n."""
    if n < fix[1]:
        return bytes([fix[0] | n])
    for code, width in wide:
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"length {n} too large for msgpack")


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative int {n} is outside the subset")
    if n < 0x80:
        return bytes([n])
    for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"int {n} too large for msgpack")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) < 32:
        return bytes([0xA0 | len(raw)]) + raw
    return _header(len(raw), (0, 0), ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + raw


def _bin(b: bytes) -> bytes:
    return _header(len(b), (0, 0), ((0xC4, 1), (0xC5, 2), (0xC6, 4))) + b


def _ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be serialized")
    payload = (_header(3, (0x90, 16), ())
               + _header(arr.ndim, (0x90, 16), ((0xDC, 2), (0xDD, 4)))
               + b"".join(_uint(int(d)) for d in arr.shape)
               + _str(arr.dtype.name) + _bin(arr.tobytes("C")))
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _header(n, (0, 0), ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
    return head + bytes([_NDARRAY]) + payload


def _value(v) -> bytes:
    if isinstance(v, Mapping):
        return (_header(len(v), (0x80, 16), ((0xDE, 2), (0xDF, 4)))
                + b"".join(_str(k) + _value(v[k]) for k in sorted(v)))
    if isinstance(v, np.ndarray):
        if v.nbytes > 1 << 30:
            raise ValueError("arrays over 1 GiB need flax's chunked form, which "
                             "this writer does not produce")
        return _ndarray(v)
    raise ValueError(f"a params tree holds maps and numpy arrays, not {type(v).__name__}")


def dumps(tree: Mapping) -> bytes:
    """Nested dicts of numpy arrays -> the bytes flax's ``to_bytes`` writes
    for the same tree."""
    return _value(tree)
