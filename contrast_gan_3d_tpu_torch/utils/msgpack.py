"""A msgpack decoder in plain Python, and flax's serialization format on
top of it, so the port reads the JAX package's ``<step>.msgpack``
checkpoints on a machine without the ``msgpack`` package (the card's has
none).

``unpackb(data)`` decodes one msgpack object: nil, booleans, integers,
floats, str (utf-8), bin (``bytes``), arrays (lists), maps (dicts) and
ext types, which ``ext_hook(code, data)`` turns into values (default:
:class:`ExtType`). ``msgpack_restore(data)`` is flax's
``serialization.msgpack_restore``:
- ext 1 is an ndarray, itself a msgpack array (shape, dtype name, C-order
  bytes); a ``bfloat16`` array is widened to float32 (exactly: bf16 is
  the top half of an f32), since numpy has no bfloat16;
- ext 2 is a Python complex, a msgpack (real, imag) pair;
- ext 3 is a numpy scalar, encoded as a 0-d ndarray;
- a dict holding ``__msgpack_chunked_array__`` is an array that flax
  split into flattened chunks of at most ``MAX_CHUNK_SIZE`` bytes; it is
  joined back.
"""

import struct
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax's: arrays above it are written in chunks
CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext value no hook decoded: its type code and raw bytes."""

    code: int
    data: bytes


def _fixed(fmt: str):
    size = struct.calcsize(fmt)
    return lambda r: struct.unpack(fmt, r.take(size))[0]


def _sized(fmt: str, read):
    """A value whose length is a ``fmt`` integer, read by ``read(reader, n)``."""
    length = _fixed(fmt)
    return lambda r: read(r, length(r))


def _ext(r, n: int):
    code = struct.unpack(">b", r.take(1))[0]
    data = bytes(r.take(n))
    return r.ext_hook(code, data)


class _Reader:
    def __init__(self, data, ext_hook: Callable[[int, bytes], Any]):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}: {n} more wanted at {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.str(b & 0x1F)
        typed = _TYPED.get(b)
        if typed is None:
            raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack value")
        return typed(self)


_TYPED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: _sized(">B", _Reader.bin),
    0xC5: _sized(">H", _Reader.bin),
    0xC6: _sized(">I", _Reader.bin),
    0xC7: _sized(">B", _ext),
    0xC8: _sized(">H", _ext),
    0xC9: _sized(">I", _ext),
    0xCA: _fixed(">f"),
    0xCB: _fixed(">d"),
    0xCC: _fixed(">B"),
    0xCD: _fixed(">H"),
    0xCE: _fixed(">I"),
    0xCF: _fixed(">Q"),
    0xD0: _fixed(">b"),
    0xD1: _fixed(">h"),
    0xD2: _fixed(">i"),
    0xD3: _fixed(">q"),
    **{0xD4 + i: (lambda n: lambda r: _ext(r, n))(1 << i) for i in range(5)},
    0xD9: _sized(">B", _Reader.str),
    0xDA: _sized(">H", _Reader.str),
    0xDB: _sized(">I", _Reader.str),
    0xDC: _sized(">H", _Reader.array),
    0xDD: _sized(">I", _Reader.array),
    0xDE: _sized(">H", _Reader.map),
    0xDF: _sized(">I", _Reader.map),
}


def unpackb(data, ext_hook: Optional[Callable[[int, bytes], Any]] = None) -> Any:
    """The one msgpack object that ``data`` holds (trailing bytes raise)."""
    reader = _Reader(data, ext_hook or ExtType)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes follow the msgpack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buffer = unpackb(data)
    if dtype == "bfloat16":
        wide = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return wide.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype)).reshape(shape).copy()


def _flax_ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    return ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> Any:
    """flax ``serialization.msgpack_restore``: the nested dicts of a flax
    state dict with numpy leaves."""
    return _unchunk(unpackb(data, _flax_ext))
