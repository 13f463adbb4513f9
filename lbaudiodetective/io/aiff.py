"""AIFF / AIFF-C decoding (big-endian PCM 8/16/24/32-bit, 'sowt'
little-endian PCM, 'fl32'/'fl64' float, 'ulaw'/'alaw' G.711), pure NumPy.

The reference accepts any container AudioToolbox can open
(LBAudioDetective.h:210-235); AIFF is the classic Apple interchange format,
so the framework decodes it natively alongside CAF and WAV.

IFF structure: 'FORM' <size> 'AIFF'|'AIFC', chunks 'COMM' (channels, frame
count, bit depth, 80-bit extended-float sample rate, + compression type for
AIFC) and 'SSND' (offset, block size, sample data); chunks are word-aligned.
"""

from __future__ import annotations

import struct

import numpy as np

from lbaudiodetective.errors import DecodeError, UnsupportedFormatError
from lbaudiodetective.io.pcm import downmix_mean, pcm24_to_float, whole


def _read_extended80(b: bytes) -> float:
    """IEEE 754 80-bit extended float (the COMM sampleRate field)."""
    if len(b) < 10:
        raise DecodeError("truncated 80-bit extended float")
    (se,) = struct.unpack(">H", b[:2])
    (mant,) = struct.unpack(">Q", b[2:10])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    if exp == 0x7FFF:
        raise DecodeError("non-finite AIFF sample rate")
    return sign * float(mant) * 2.0 ** (exp - 16383 - 63)


def _write_extended80(x: float) -> bytes:
    if x == 0.0:
        return b"\x00" * 10
    sign = 0x8000 if x < 0 else 0
    x = abs(x)
    exp = int(np.floor(np.log2(x)))
    mant = int(round(x * 2.0 ** (63 - exp)))
    if mant >= 1 << 64:            # rounding overflow: renormalise
        mant >>= 1
        exp += 1
    return struct.pack(">HQ", sign | (exp + 16383), mant)


def read_aiff(path: str) -> tuple[np.ndarray, float]:
    """Read an AIFF/AIFF-C file -> (mono float32 samples in [-1,1), rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12 or raw[:4] != b"FORM" or raw[8:12] not in (b"AIFF", b"AIFC"):
        raise DecodeError("not an AIFF/AIFF-C file")
    is_aifc = raw[8:12] == b"AIFC"
    off, n = 12, len(raw)
    comm = None
    comp = b"NONE"
    ssnd = None
    while off + 8 <= n:
        cid = raw[off:off + 4]
        (csize,) = struct.unpack(">I", raw[off + 4:off + 8])
        payload = off + 8
        csize = min(csize, n - payload)        # tolerate truncation
        if cid == b"COMM":
            if csize < 18:
                raise DecodeError("AIFF COMM chunk too short")
            channels, frames, bits = struct.unpack(">HIH", raw[payload:payload + 8])
            rate = _read_extended80(raw[payload + 8:payload + 18])
            comm = (channels, frames, bits, rate)
            if is_aifc and csize >= 22:
                comp = raw[payload + 18:payload + 22]
        elif cid == b"SSND":
            if csize < 8:
                raise DecodeError("AIFF SSND chunk too short")
            data_off, _block = struct.unpack(">II", raw[payload:payload + 8])
            ssnd = raw[payload + 8 + data_off:payload + csize]
        off = payload + csize + (csize & 1)    # chunks are word-aligned
    if comm is None or ssnd is None:
        raise DecodeError("AIFF missing COMM or SSND chunk")
    channels, frames, bits, rate = comm
    if channels < 1 or not (0 < rate < 1e7):     # rejects 0/negative/nan/inf
        raise DecodeError("invalid AIFF COMM parameters")

    if comp in (b"NONE", b"sowt"):
        endian = "<" if comp == b"sowt" else ">"
        if bits == 8:                      # AIFF 8-bit PCM is SIGNED
            x = np.frombuffer(ssnd, np.int8).astype(np.float32) / 128.0
        elif bits == 16:
            x = np.frombuffer(whole(ssnd, 2), endian + "i2"
                              ).astype(np.float32) / 32768.0
        elif bits == 24:
            x = pcm24_to_float(ssnd, little=(comp == b"sowt"))
        elif bits == 32:
            x = np.frombuffer(whole(ssnd, 4), endian + "i4"
                              ).astype(np.float32) / 2147483648.0
        else:
            raise UnsupportedFormatError(f"unsupported AIFF bit depth {bits}")
    elif comp in (b"fl32", b"FL32"):
        x = np.frombuffer(whole(ssnd, 4), ">f4").astype(np.float32)
    elif comp in (b"fl64", b"FL64"):
        x = np.frombuffer(whole(ssnd, 8), ">f8").astype(np.float32)
    elif comp in (b"ulaw", b"ULAW", b"alaw", b"ALAW"):
        from lbaudiodetective.io.g711 import decode_alaw, decode_mulaw
        x = (decode_mulaw if comp.lower() == b"ulaw" else decode_alaw)(ssnd)
    else:
        raise UnsupportedFormatError(
            f"unsupported AIFF-C compression type {comp!r}")

    x = downmix_mean(x, channels)
    if frames and len(x) > frames:         # COMM frame count wins over slack
        x = x[:frames]
    return np.ascontiguousarray(x, np.float32), float(rate)


def write_aiff(path: str, samples: np.ndarray, sample_rate: float) -> None:
    """Write mono float32 samples as 16-bit big-endian AIFF (test helper)."""
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm_b = np.round(pcm * 32767.0).astype(">i2").tobytes()
    comm = (b"COMM" + struct.pack(">IHIH", 18, 1, len(pcm), 16)
            + _write_extended80(float(sample_rate)))
    ssnd = b"SSND" + struct.pack(">III", 8 + len(pcm_b), 0, 0) + pcm_b
    if len(pcm_b) & 1:
        ssnd += b"\x00"
    body = b"AIFF" + comm + ssnd
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)
