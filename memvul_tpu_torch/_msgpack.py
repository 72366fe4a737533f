"""A small msgpack codec for the subset flax's serialization writes.

The archive's ``weights.msgpack`` is ``flax.serialization.to_bytes`` of the
param tree: nested maps of str keys whose leaves are ndarrays.  This
module reads and writes that format without the ``msgpack`` package:

* nil, bool, int, float, str, bin, array and map;
* ext type 1, an ndarray: its payload is itself a msgpack array
  ``(shape, dtype_name, C-order bytes)``.  Leaves decode to numpy arrays,
  except ``bfloat16`` (which numpy lacks), which decodes to a
  ``torch.bfloat16`` tensor;
* ext type 3, a numpy scalar, with the same payload.

Arrays over 2^30 bytes, which flax splits into ``__msgpack_chunked_array__``
maps, are refused: no leaf of a BERT-base or BERT-large encoder is that
large.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# -- decoding ----------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


def _ndarray_from_payload(payload: bytes):
    shape, dtype_name, buffer = unpackb(bytes(payload))
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(bytes(buffer), dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray_from_payload(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack: unsupported ext type {code}")


def _decode(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return bytes(r.take(n)).decode("utf-8")
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_decode(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    if "__msgpack_chunked_array__" in out:
        raise ValueError(
            "msgpack: chunked array leaf (an array over 2^30 bytes) is not supported"
        )
    return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the whole input)."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes after the object")
    return obj


# -- encoding ----------------------------------------------------------------


def _len_header(n: int, fix: Tuple[int, int], codes: Tuple[int, ...]) -> bytes:
    fix_base, fix_max = fix
    if fix_max and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _encode_int(x: int) -> bytes:
    if 0 <= x <= 0x7F:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if x <= limit:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                                 (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if x >= -limit:
                return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f"msgpack: int {x} out of range")


def _array_payload(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
            name, raw = arr.dtype.name, arr.tobytes("C")
        shape = tuple(t.shape)
    else:
        arr = np.asarray(x)
        if arr.dtype.hasobject:
            raise ValueError("msgpack: object arrays are not supported")
        name, raw, shape = arr.dtype.name, arr.tobytes("C"), arr.shape
    return packb([list(shape), name, raw])


def _encode_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _len_header(n, (0, 0), (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _encode(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if isinstance(x, torch.Tensor) and x.ndim == 0:
            out.append(_encode_ext(EXT_NPSCALAR, _array_payload(x)))
        else:
            out.append(_encode_ext(EXT_NDARRAY, _array_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_encode_ext(EXT_NPSCALAR, _array_payload(np.asarray(x))))
    elif isinstance(x, int):
        out.append(_encode_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_len_header(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        out.append(_len_header(len(raw), (0, 0), (0xC4, 0xC5, 0xC6)) + raw)
    elif isinstance(x, (list, tuple)):
        out.append(_len_header(len(x), (0x90, 15), (None, 0xDC, 0xDD)))
        for item in x:
            _encode(item, out)
    elif isinstance(x, dict):
        out.append(_len_header(len(x), (0x80, 15), (None, 0xDE, 0xDF)))
        for key, value in x.items():
            _encode(key, out)
            _encode(value, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(x).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` (ndarray / torch tensor leaves as flax's ext types)."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)
