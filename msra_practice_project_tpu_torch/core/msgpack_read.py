"""A reader of the msgpack checkpoints the JAX package writes (flax's
``serialization.to_bytes``), in plain Python, so the port loads them
without ``msgpack`` or ``flax``.

flax turns the state into nested string-keyed maps before it packs them:
dicts stay maps, tuples and lists become maps keyed "0", "1", ..., and
namedtuples (optax's ``ScaleByAdamState``) maps keyed by their field names.
Leaves are nil, booleans, integers, floats, strings and two ext types:
  * 1, an ndarray: a packed array ``[shape, dtype name, C-order bytes]``;
  * 3, a numpy scalar: the same, for a 0-d array.
Arrays come back as CPU tensors (``bfloat16`` too, which numpy lacks);
scalars as Python numbers.  Data that ends early or holds a byte no
msgpack writer emits raises ``ValueError`` (a torn or corrupt file); valid
msgpack that this reader does not decode (another ext type, an array dtype
missing from ``_DTYPES``) raises ``Unsupported``.
"""

from __future__ import annotations

import struct

import torch

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class Unsupported(Exception):
    """Well-formed msgpack holding a value this reader does not decode.
    Not a ``ValueError``: the file is whole, and skipping it as torn would
    lose a run's state."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data truncated at byte {self.pos} "
                             f"(wanted {n} of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {  # marker -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:   # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        raise ValueError(f"msgpack marker 0x{b:02x} at byte {self.pos - 1} "
                         "is not one this reader knows")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        body = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise Unsupported(f"msgpack ext type {code} is not an array")
        inner = _Reader(body)
        shape, name, buf = inner.value()
        if isinstance(name, bytes):
            name = name.decode()
        if name not in _DTYPES:
            raise Unsupported(f"array dtype {name!r} is not supported")
        t = torch.frombuffer(bytearray(buf), dtype=_DTYPES[name]) \
            if buf else torch.empty(0, dtype=_DTYPES[name])
        t = t.reshape(shape)
        return t.item() if code == _EXT_NPSCALAR else t


def loads(data: bytes):
    """Decode one msgpack object (the whole of ``data``)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes after the msgpack "
                         "object")
    return out


def is_map_start(head: bytes) -> bool:
    """Whether ``head`` begins a msgpack map (flax's top level)."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE,
                                                                0xDF))
