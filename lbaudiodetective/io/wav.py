"""RIFF/WAVE decoding, pure NumPy.

Codecs: integer PCM 16/24/32-bit, float32/64, G.711 mu-law/A-law
(format tags 7/6) and IMA/DVI ADPCM (format tag 0x11, mono).

The reference accepts any container AudioToolbox can open
(LBAudioDetective.h documents audio file URLs generally); the bundled corpus
is CAF, but WAV is the common interchange format, so the framework decodes it
natively too.
"""

from __future__ import annotations

import struct

import numpy as np

from lbaudiodetective.errors import DecodeError, UnsupportedFormatError
from lbaudiodetective.io.pcm import downmix_mean, pcm24_to_float, whole


def decode_ima_adpcm_mono(data: bytes, block_align: int,
                          total_frames: int = -1) -> np.ndarray:
    """Decode mono IMA/DVI ADPCM (WAV format tag 0x11) to float32.

    Each ``block_align``-byte block: 4-byte header (int16 LE predictor —
    emitted as the block's FIRST sample — uint8 step index, reserved byte)
    followed by nibble-packed deltas, low nibble first.  Vectorised over
    blocks exactly like the CAF IMA4 decoder (the per-sample recurrence is
    the only sequential dimension); ``total_frames`` (the ``fact`` chunk)
    trims the final partial block.
    """
    from lbaudiodetective.io.caf import IMA_INDEX_TABLE, IMA_STEP_TABLE

    if block_align < 5:
        raise DecodeError(f"IMA ADPCM block_align {block_align} too small")
    n_blocks = len(data) // block_align
    if n_blocks == 0:
        return np.zeros(0, dtype=np.float32)
    raw = np.frombuffer(data[:n_blocks * block_align], dtype=np.uint8)
    raw = raw.reshape(n_blocks, block_align)

    predictor = raw[:, :2].copy().view("<i2")[:, 0].astype(np.int32)
    step_index = np.clip(raw[:, 2].astype(np.int32), 0, 88)

    body = raw[:, 4:]                                  # [B, block_align-4]
    n_nib = body.shape[1] * 2
    nibbles = np.empty((n_blocks, n_nib), dtype=np.int32)
    nibbles[:, 0::2] = body & 0x0F                     # low nibble first
    nibbles[:, 1::2] = body >> 4

    out = np.empty((n_blocks, 1 + n_nib), dtype=np.int16)
    out[:, 0] = predictor                              # header IS sample 0
    for t in range(n_nib):
        nib = nibbles[:, t]
        step = IMA_STEP_TABLE[step_index]
        diff = step >> 3
        diff += np.where(nib & 1, step >> 2, 0)
        diff += np.where(nib & 2, step >> 1, 0)
        diff += np.where(nib & 4, step, 0)
        diff = np.where(nib & 8, -diff, diff)
        predictor = np.clip(predictor + diff, -32768, 32767)
        step_index = np.clip(step_index + IMA_INDEX_TABLE[nib], 0, 88)
        out[:, 1 + t] = predictor

    samples = out.reshape(-1)
    if 0 <= total_frames < samples.size:
        samples = samples[:total_frames]
    return samples.astype(np.float32) / 32768.0


def read_wav(path: str) -> tuple[np.ndarray, float]:
    """Read a WAV file -> (mono float32 samples in [-1,1), sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise DecodeError("not a RIFF/WAVE file")
    off = 12
    fmt = None
    data = None
    fact_frames = -1
    n = len(raw)
    while off + 8 <= n:
        cid = raw[off:off + 4]
        (csize,) = struct.unpack("<I", raw[off + 4:off + 8])
        payload = off + 8
        csize = min(csize, n - payload)  # tolerate truncation
        if cid == b"fmt ":
            if csize < 16:
                raise DecodeError("WAV fmt chunk truncated")
            fmt = struct.unpack("<HHIIHH", raw[payload:payload + 16])
            fmt_payload = raw[payload:payload + csize]
        elif cid == b"data":
            data = raw[payload:payload + csize]
        elif cid == b"fact" and csize >= 4:
            (fact_frames,) = struct.unpack("<I", raw[payload:payload + 4])
        off = payload + csize + (csize & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise DecodeError("WAV missing fmt or data chunk")
    audio_format, channels, sample_rate, _, block_align, bits = fmt
    if sample_rate <= 0:
        raise DecodeError(f"WAV sample rate {sample_rate} is not usable")
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # The real format code is the first 2 bytes of the SubFormat GUID at
        # offset 24 of the extended fmt chunk (after cbSize/validBits/mask).
        # Bit depth alone cannot distinguish 32-bit int PCM from float32.
        if len(fmt_payload) >= 26:
            (audio_format,) = struct.unpack("<H", fmt_payload[24:26])
        else:
            raise UnsupportedFormatError(
                "WAVE_FORMAT_EXTENSIBLE fmt chunk too short to carry the "
                "SubFormat GUID")
        if audio_format not in (1, 3, 6, 7):
            raise UnsupportedFormatError(
                f"unsupported WAVE_FORMAT_EXTENSIBLE SubFormat {audio_format}")

    if audio_format == 1:  # integer PCM
        if bits == 16:
            x = np.frombuffer(whole(data, 2), "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            x = pcm24_to_float(data, little=True)
        elif bits == 32:
            x = np.frombuffer(whole(data, 4), "<i4").astype(np.float32) / 2147483648.0
        else:
            raise UnsupportedFormatError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = {32: "<f4", 64: "<f8"}.get(bits)
        if dtype is None:
            raise UnsupportedFormatError(f"unsupported float bit depth {bits}")
        x = np.frombuffer(whole(data, bits // 8), dtype).astype(np.float32)
    elif audio_format == 6:  # G.711 A-law
        from lbaudiodetective.io.g711 import decode_alaw
        x = decode_alaw(data)
    elif audio_format == 7:  # G.711 mu-law
        from lbaudiodetective.io.g711 import decode_mulaw
        x = decode_mulaw(data)
    elif audio_format == 0x11:  # IMA/DVI ADPCM
        if channels != 1:
            raise UnsupportedFormatError(
                "only mono IMA ADPCM WAV is supported")
        return (decode_ima_adpcm_mono(data, block_align, fact_frames),
                float(sample_rate))
    else:
        raise UnsupportedFormatError(f"unsupported WAV format code {audio_format}")

    x = downmix_mean(x, channels)
    return np.ascontiguousarray(x, np.float32), float(sample_rate)


def write_wav(path: str, samples: np.ndarray, sample_rate: float) -> None:
    """Write mono float32 samples as 16-bit PCM WAV (test/tooling helper)."""
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, int(sample_rate),
                                int(sample_rate) * 2, 2, 16)
    data = b"data" + struct.pack("<I", len(pcm)) + pcm
    with open(path, "wb") as f:
        f.write(hdr + fmt + data)
