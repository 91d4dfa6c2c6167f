"""Minimal self-contained CBOR codec (RFC 8949 subset) for checkpoint files.

The port's copy of ``pyisingmontecarlo_tpu/utils/cbor.py`` (numpy and
``struct`` only), so that both packages read and write the same checkpoint
files: CBOR framing of a schema tuple, as the original Rust library's
serde_cbor "packed format" files. Supported types: None, bool, int (signed 64-bit range and
beyond via bignum-free chunking is NOT needed — values are validated), float
(encoded f64), bytes, str, list/tuple (-> array), dict (-> map), and numpy
arrays (-> tagged map {"__nd__": 1, "dtype", "shape", "data"}).
"""

from __future__ import annotations

import struct
from typing import Any, IO

import numpy as np

__all__ = ["dumps", "loads", "dump", "load"]


def _enc_head(fp: IO[bytes], major: int, val: int) -> None:
    if val < 24:
        fp.write(bytes([(major << 5) | val]))
    elif val < 0x100:
        fp.write(bytes([(major << 5) | 24, val]))
    elif val < 0x10000:
        fp.write(bytes([(major << 5) | 25]) + struct.pack(">H", val))
    elif val < 0x100000000:
        fp.write(bytes([(major << 5) | 26]) + struct.pack(">I", val))
    else:
        fp.write(bytes([(major << 5) | 27]) + struct.pack(">Q", val))


def _encode(fp: IO[bytes], obj: Any) -> None:
    if obj is None:
        fp.write(b"\xf6")
    elif isinstance(obj, bool):
        fp.write(b"\xf5" if obj else b"\xf4")
    elif isinstance(obj, (int, np.integer)):
        obj = int(obj)
        if obj >= 0:
            if obj >= 1 << 64:
                raise ValueError("integer too large for CBOR encoding")
            _enc_head(fp, 0, obj)
        else:
            if -obj - 1 >= 1 << 64:
                raise ValueError("integer too large for CBOR encoding")
            _enc_head(fp, 1, -obj - 1)
    elif isinstance(obj, (float, np.floating)):
        fp.write(b"\xfb" + struct.pack(">d", float(obj)))
    elif isinstance(obj, (bytes, bytearray)):
        _enc_head(fp, 2, len(obj))
        fp.write(bytes(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _enc_head(fp, 3, len(b))
        fp.write(b)
    elif isinstance(obj, (list, tuple)):
        _enc_head(fp, 4, len(obj))
        for x in obj:
            _encode(fp, x)
    elif isinstance(obj, dict):
        _enc_head(fp, 5, len(obj))
        for k, v in obj.items():
            _encode(fp, k)
            _encode(fp, v)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        _encode(
            fp,
            {"__nd__": 1, "dtype": arr.dtype.str, "shape": list(arr.shape), "data": arr.tobytes()},
        )
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj)}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated CBOR data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def head(self):
        b = self.take(1)[0]
        major, info = b >> 5, b & 0x1F
        if info < 24:
            return major, info
        if info == 24:
            return major, self.take(1)[0]
        if info == 25:
            return major, struct.unpack(">H", self.take(2))[0]
        if info == 26:
            return major, struct.unpack(">I", self.take(4))[0]
        if info == 27:
            return major, struct.unpack(">Q", self.take(8))[0]
        raise ValueError(f"unsupported CBOR additional info {info}")


def _decode(r: _Reader) -> Any:
    if r.pos >= len(r.data):
        raise ValueError("truncated CBOR data")
    b = r.data[r.pos]
    if b == 0xF6:
        r.pos += 1
        return None
    if b == 0xF5:
        r.pos += 1
        return True
    if b == 0xF4:
        r.pos += 1
        return False
    if b == 0xFB:
        r.pos += 1
        return struct.unpack(">d", r.take(8))[0]
    major, val = r.head()
    if major == 0:
        return val
    if major == 1:
        return -1 - val
    if major == 2:
        return r.take(val)
    if major == 3:
        return r.take(val).decode("utf-8")
    if major == 4:
        return [_decode(r) for _ in range(val)]
    if major == 5:
        d = {_decode(r): _decode(r) for _ in range(val)}
        if d.get("__nd__") == 1:
            return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()
        return d
    raise ValueError(f"unsupported CBOR major type {major}")


def dumps(obj: Any) -> bytes:
    import io

    fp = io.BytesIO()
    _encode(fp, obj)
    return fp.getvalue()


def loads(data: bytes) -> Any:
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(data):
        raise ValueError("trailing CBOR data")
    return out


def dump(obj: Any, path: str) -> None:
    try:
        with open(path, "wb") as f:
            f.write(dumps(obj))
    except OSError as e:
        raise IOError(str(e)) from e


def load(path: str) -> Any:
    try:
        with open(path, "rb") as f:
            return loads(f.read())
    except OSError as e:
        raise IOError(str(e)) from e
