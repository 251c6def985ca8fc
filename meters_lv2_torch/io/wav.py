"""WAV ingest and egress: the native C++ codec with a pure-Python fallback.

The native codec is the port's own build of ``native/wavio.cc``
(``runtime/native.py``).  The Python reader and writer are copies of
``meters_lv2_tpu/io/wav.py``'s.
"""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path: str):
    """(data [C, T] float32 planar, sample rate).

    Only the native library's unavailability falls back to the Python
    parser: a native decode error on a corrupt file propagates rather than
    re-parsing, since the Python parser could return a partial decode of a
    truncated file."""
    from ..runtime import native

    if native.load() is None:
        return _read_wav_py(path)
    return native.wav_read(path)


def write_wav(path: str, data: np.ndarray, rate: int, format: int = 32):
    """Write planar float32 [C, T] (format 16 = PCM16, 32 = float32)."""
    from ..runtime import native

    if native.load() is None:
        _write_wav_py(path, data, rate, format)
    else:
        native.wav_write(path, data, rate, format)


def _read_wav_py(path: str):
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = ch = bits = rate = None
    data = None
    while pos + 8 <= len(buf):
        tag = buf[pos : pos + 4]
        (ln,) = struct.unpack_from("<I", buf, pos + 4)
        body = buf[pos + 8 : pos + 8 + ln]
        if tag == b"fmt ":
            fmt, ch, rate = struct.unpack_from("<HHI", body, 0)
            bits = struct.unpack_from("<H", body, 14)[0]
            if fmt == 0xFFFE and ln >= 40:
                fmt = struct.unpack_from("<H", body, 24)[0]
        elif tag == b"data":
            data = body
        pos += 8 + ln + (ln & 1)
    if data is None or not ch:
        raise ValueError(f"{path}: no fmt or data chunk")
    if fmt == 3 and bits == 32:
        x = np.frombuffer(data, "<f4")
    elif fmt == 3 and bits == 64:
        x = np.frombuffer(data, "<f8").astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
        v = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        v = (v << 8) >> 8  # sign extend
        x = v.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV fmt={fmt} bits={bits}")
    frames = len(x) // ch
    return (
        np.ascontiguousarray(x[: frames * ch].reshape(frames, ch).T.astype(np.float32)),
        rate,
    )


def _write_wav_py(path: str, data: np.ndarray, rate: int, format: int = 32):
    data = np.asarray(data, np.float32)
    c, t = data.shape
    inter = np.ascontiguousarray(data.T)
    if format == 16:
        payload = (np.clip(inter, -1, 1) * 32767.0).astype("<i2").tobytes()
        fmt, bits = 1, 16
    else:
        payload = inter.astype("<f4").tobytes()
        fmt, bits = 3, 32
    bytes_ps = bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, fmt, c, rate, rate * c * bytes_ps,
                c * bytes_ps, bits,
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
