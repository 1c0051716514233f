"""WAV read/write without external dependencies.

Port of ``wayverb_tpu.utils.audio``: numpy on the host, writing the same
bytes as the reference for the same samples.

Replaces the reference's libsndfile wrapper (``src/audio_file``): 16/24-bit
PCM and 32-bit float WAV, mono or multichannel.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def _host(data) -> np.ndarray:
    """Samples as float64 numpy; a tensor is read back from its device."""
    if hasattr(data, "detach"):
        data = data.detach().cpu().numpy()
    return np.asarray(data, dtype=np.float64)


def write_wav(path: str, data, sample_rate: float,
              bit_depth: str = "float32") -> None:
    """Write (n,) or (channels, n) data (numpy or a tensor) to a WAV file.

    ``bit_depth``: "pcm16", "pcm24", or "float32".
    """
    arr = _host(data)
    if arr.ndim == 1:
        arr = arr[None, :]
    channels, n = arr.shape
    interleaved = arr.T.reshape(-1)

    if bit_depth == "float32":
        payload = interleaved.astype("<f4").tobytes()
        fmt_tag, bits = 3, 32
    elif bit_depth == "pcm16":
        clipped = np.clip(interleaved, -1.0, 1.0)
        payload = (clipped * 32767.0).astype("<i2").tobytes()
        fmt_tag, bits = 1, 16
    elif bit_depth == "pcm24":
        clipped = np.clip(interleaved, -1.0, 1.0)
        ints = (clipped * 8388607.0).astype("<i4")
        raw = ints.astype("<i4").tobytes()
        payload = b"".join(raw[i:i + 3] for i in range(0, len(raw), 4))
        fmt_tag, bits = 1, 24
    else:
        raise ValueError(f"unknown bit depth {bit_depth}")

    byte_rate = int(sample_rate) * channels * bits // 8
    block_align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, int(sample_rate),
                      byte_rate, block_align, bits)
    with open(path, "wb") as f:
        data_chunk = b"data" + struct.pack("<I", len(payload)) + payload
        fmt_chunk = b"fmt " + struct.pack("<I", len(fmt)) + fmt
        body = b"WAVE" + fmt_chunk + data_chunk
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def read_wav(path: str) -> Tuple[np.ndarray, float]:
    """Read a WAV file → ((channels, n) float64 in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt_tag = channels = rate = bits = None
        data = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            cid, size = header[:4], struct.unpack("<I", header[4:])[0]
            chunk = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt_tag, channels, rate, _, _, bits = struct.unpack(
                    "<HHIIHH", chunk[:16])
            elif cid == b"data":
                data = chunk
        if data is None or fmt_tag is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

    if fmt_tag == 3 and bits == 32:
        arr = np.frombuffer(data, dtype="<f4").astype(np.float64)
    elif fmt_tag == 1 and bits == 16:
        arr = np.frombuffer(data, dtype="<i2").astype(np.float64) / 32767.0
    elif fmt_tag == 1 and bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        ints = (raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        arr = ints.astype(np.float64) / 8388607.0
    else:
        raise ValueError(f"{path}: unsupported format {fmt_tag}/{bits}")
    return arr.reshape(-1, channels).T, float(rate)


def _f80(rate: float) -> bytes:
    """80-bit IEEE 754 extended float (AIFF COMM sample rate)."""
    if rate <= 0:
        return b"\x00" * 10
    import math
    m, e = math.frexp(rate)
    exponent = e + 16382
    mantissa = int(m * (1 << 64))
    return struct.pack(">H", exponent) + struct.pack(">Q", mantissa)


def _read_f80(raw: bytes) -> float:
    exponent = struct.unpack(">H", raw[:2])[0]
    mantissa = struct.unpack(">Q", raw[2:10])[0]
    if exponent == 0 and mantissa == 0:
        return 0.0
    return float(mantissa) * 2.0 ** (exponent - 16383 - 63)


def write_aiff(path: str, data, sample_rate: float,
               bit_depth: str = "pcm16") -> None:
    """Write (n,) or (channels, n) data to an AIFF file (pcm16/pcm24).

    Parity: the reference writes WAV and AIFF via libsndfile
    (``threaded_engine.cpp:241-280``); AIFF is big-endian PCM with an
    80-bit extended-float sample rate in the COMM chunk.
    """
    arr = _host(data)
    if arr.ndim == 1:
        arr = arr[None, :]
    channels, n = arr.shape
    interleaved = np.clip(arr.T.reshape(-1), -1.0, 1.0)

    if bit_depth == "pcm16":
        payload = (interleaved * 32767.0).astype(">i2").tobytes()
        bits = 16
    elif bit_depth == "pcm24":
        ints = (interleaved * 8388607.0).astype(">i4").tobytes()
        payload = b"".join(ints[i + 1:i + 4]
                           for i in range(0, len(ints), 4))
        bits = 24
    else:
        raise ValueError(f"unsupported AIFF bit depth {bit_depth}")

    comm = struct.pack(">hIh", channels, n, bits) + _f80(sample_rate)
    ssnd = struct.pack(">II", 0, 0) + payload
    chunks = b"COMM" + struct.pack(">I", len(comm)) + comm
    chunks += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    if len(ssnd) & 1:
        chunks += b"\x00"
    body = b"AIFF" + chunks
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


def read_aiff(path: str) -> Tuple[np.ndarray, float]:
    """Read an AIFF file → ((channels, n) float64 in [-1, 1], rate)."""
    with open(path, "rb") as f:
        form = f.read(12)
        if form[:4] != b"FORM" or form[8:12] != b"AIFF":
            raise ValueError(f"{path}: not a FORM/AIFF file")
        channels = bits = None
        rate = 0.0
        data = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            cid, size = header[:4], struct.unpack(">I", header[4:])[0]
            chunk = f.read(size + (size & 1))[:size]
            if cid == b"COMM":
                channels, _, bits = struct.unpack(">hIh", chunk[:8])
                rate = _read_f80(chunk[8:18])
            elif cid == b"SSND":
                # honour the SSND offset field — sample data legally
                # starts `offset` bytes past the 8-byte chunk header
                offset = struct.unpack(">I", chunk[:4])[0]
                data = chunk[8 + offset:]
        if data is None or channels is None:
            raise ValueError(f"{path}: missing COMM/SSND chunk")

    if bits == 16:
        arr = np.frombuffer(data, dtype=">i2").astype(np.float64) / 32767.0
    elif bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        ints = ((raw[:, 0].astype(np.int32) << 16)
                | (raw[:, 1].astype(np.int32) << 8)
                | raw[:, 2].astype(np.int32))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        arr = ints.astype(np.float64) / 8388607.0
    else:
        raise ValueError(f"{path}: unsupported AIFF bits {bits}")
    return arr.reshape(-1, channels).T, float(rate)


def write_audio(path: str, data, sample_rate: float,
                bit_depth: str = None) -> None:
    """Extension-dispatched writer (.wav / .aif / .aiff), the
    libsndfile-style entry the reference's engine uses."""
    lower = path.lower()
    if lower.endswith((".aif", ".aiff")):
        write_aiff(path, data, sample_rate, bit_depth or "pcm16")
    else:
        write_wav(path, data, sample_rate, bit_depth or "float32")
