"""Core Audio Format (CAF) container parsing and sample decoding (pure NumPy).

Replaces the decode half of the reference's AudioToolbox usage
(`ExtAudioFileOpenURL`/`ExtAudioFileRead`, LBAudioDetective.m:224,275).  The
bundled Birds corpus uses two codecs (verified by parsing the files):

- ``ima4``: Apple IMA4 ADPCM, mono, 34-byte packets of 64 frames (2-byte
  big-endian state header + 32 nibble-packed bytes, low nibble first).
- ``lpcm``: 32-bit little-endian *integer* PCM (format flags = 2 =
  kCAFLinearPCMFormatFlagIsLittleEndian, float flag clear).

The IMA4 decoder is vectorised across packets: packets carry their own
predictor/step state so the only sequential dimension is the 64 samples inside
a packet; we loop over those 64 positions with NumPy ops over all packets at
once.  A C++ implementation lives in ``native/`` for the hot path.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from lbaudiodetective.errors import DecodeError, UnsupportedFormatError

# Standard IMA ADPCM tables.
IMA_INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)
IMA_STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
    50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190, 209, 230,
    253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724, 796, 876, 963,
    1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327,
    3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442,
    11487, 12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794,
    32767], dtype=np.int32)

IMA4_PACKET_BYTES = 34
IMA4_FRAMES_PER_PACKET = 64


@dataclasses.dataclass
class CafAudioDescription:
    """Decoded ``desc`` chunk (CAFAudioFormat, CAF spec)."""

    sample_rate: float
    format_id: str
    format_flags: int
    bytes_per_packet: int
    frames_per_packet: int
    channels_per_frame: int
    bits_per_channel: int


@dataclasses.dataclass
class CafFile:
    desc: CafAudioDescription
    data: bytes          # data chunk payload, edit-count stripped
    valid_frames: int    # from pakt chunk when present, else derived


def parse_caf(raw: bytes) -> CafFile:
    if raw[:4] != b"caff":
        raise DecodeError("not a CAF file (missing 'caff' magic)")
    off = 8
    desc = None
    data = None
    valid_frames = -1
    n = len(raw)
    while off + 12 <= n:
        ctype = raw[off:off + 4]
        (csize,) = struct.unpack(">q", raw[off + 4:off + 12])
        payload_off = off + 12
        if csize == -1:  # audio data extends to EOF (allowed for 'data')
            csize = n - payload_off
        if ctype == b"desc":
            if payload_off + 32 > n:
                raise DecodeError("CAF desc chunk truncated")
            sr, fmt, flags, bpp, fpp, cpf, bpc = struct.unpack(
                ">dIIIIII", raw[payload_off:payload_off + 32])
            try:
                fmt_id = fmt.to_bytes(4, "big").decode("ascii")
            except UnicodeDecodeError:
                raise DecodeError(f"CAF format id {fmt:#x} is not ASCII")
            desc = CafAudioDescription(sr, fmt_id, flags, bpp, fpp, cpf, bpc)
        elif ctype == b"pakt" and payload_off + 24 <= n:
            _, nframes, _, _ = struct.unpack(">qqii", raw[payload_off:payload_off + 24])
            valid_frames = int(nframes)
        elif ctype == b"data":
            # First 4 bytes of the data chunk are the edit count.
            data = raw[payload_off + 4:payload_off + csize]
        off = payload_off + csize
    if desc is None or data is None:
        raise DecodeError("CAF file missing desc or data chunk")
    return CafFile(desc=desc, data=data, valid_frames=valid_frames)


def decode_ima4(data: bytes, valid_frames: int = -1) -> np.ndarray:
    """Decode mono Apple IMA4 ADPCM to float32 in [-1, 1).

    Vectorised over packets; per-packet state comes from the 2-byte header:
    top 9 bits (sign-extended, low 7 bits masked) = previous predictor, low
    7 bits = step-table index.
    """
    n_packets = len(data) // IMA4_PACKET_BYTES
    if n_packets == 0:
        return np.zeros(0, dtype=np.float32)
    raw = np.frombuffer(data[:n_packets * IMA4_PACKET_BYTES], dtype=np.uint8)
    raw = raw.reshape(n_packets, IMA4_PACKET_BYTES)

    header = (raw[:, 0].astype(np.uint16) << 8) | raw[:, 1].astype(np.uint16)
    predictor = (header & 0xFF80).astype(np.int16).astype(np.int32)
    step_index = np.clip((header & 0x7F).astype(np.int32), 0, 88)

    body = raw[:, 2:]                                  # [P, 32]
    lo = (body & 0x0F).astype(np.int32)
    hi = (body >> 4).astype(np.int32)
    nibbles = np.empty((n_packets, IMA4_FRAMES_PER_PACKET), dtype=np.int32)
    nibbles[:, 0::2] = lo                              # low nibble first
    nibbles[:, 1::2] = hi

    out = np.empty((n_packets, IMA4_FRAMES_PER_PACKET), dtype=np.int16)
    for t in range(IMA4_FRAMES_PER_PACKET):
        nib = nibbles[:, t]
        step = IMA_STEP_TABLE[step_index]
        diff = step >> 3
        diff += np.where(nib & 1, step >> 2, 0)
        diff += np.where(nib & 2, step >> 1, 0)
        diff += np.where(nib & 4, step, 0)
        diff = np.where(nib & 8, -diff, diff)
        predictor = np.clip(predictor + diff, -32768, 32767)
        step_index = np.clip(step_index + IMA_INDEX_TABLE[nib], 0, 88)
        out[:, t] = predictor

    samples = out.reshape(-1)
    if 0 <= valid_frames < samples.size:
        samples = samples[:valid_frames]
    return samples.astype(np.float32) / 32768.0


def decode_lpcm(data: bytes, desc: CafAudioDescription) -> np.ndarray:
    """Decode linear PCM to float32 in [-1, 1)."""
    is_float = bool(desc.format_flags & 1)
    little = bool(desc.format_flags & 2)
    order = "<" if little else ">"
    bits = desc.bits_per_channel
    dtype = ({32: "f4", 64: "f8"} if is_float else {16: "i2", 32: "i4"}).get(bits)
    if dtype is None:
        kind = "float" if is_float else "integer"
        raise UnsupportedFormatError(f"unsupported CAF {kind} LPCM depth {bits}")
    width = bits // 8
    data = data[: (len(data) // width) * width]   # ragged tail must not raise
    x = np.frombuffer(data, dtype=order + dtype).astype(np.float32)
    if not is_float:
        x /= float(1 << (bits - 1))
    c = desc.channels_per_frame
    if c > 1:
        x = x[: (len(x) // c) * c].reshape(-1, c).mean(axis=1)
    return x


def read_caf(path: str) -> tuple[np.ndarray, float]:
    """Read a CAF file -> (mono float32 samples in [-1,1), sample_rate)."""
    with open(path, "rb") as f:
        caf = parse_caf(f.read())
    sr = caf.desc.sample_rate
    if not (0 < sr < 1e7) or sr != sr:            # 0 / negative / nan / inf
        raise DecodeError(f"CAF sample rate {sr!r} is not usable")
    fmt = caf.desc.format_id
    if fmt == "ima4":
        if caf.desc.channels_per_frame != 1:
            raise UnsupportedFormatError("only mono IMA4 is supported")
        samples = decode_ima4(caf.data, caf.valid_frames)
    elif fmt == "lpcm":
        samples = decode_lpcm(caf.data, caf.desc)
    elif fmt in ("ulaw", "alaw"):
        from lbaudiodetective.io.g711 import decode_alaw, decode_mulaw
        samples = (decode_mulaw if fmt == "ulaw" else decode_alaw)(caf.data)
        if caf.desc.channels_per_frame > 1:
            c = caf.desc.channels_per_frame
            samples = samples[:(samples.size // c) * c].reshape(-1, c).mean(1)
        if 0 <= caf.valid_frames < samples.size:
            samples = samples[:caf.valid_frames]
        samples = np.ascontiguousarray(samples, np.float32)
    else:
        raise UnsupportedFormatError(f"unsupported CAF codec {fmt!r}")
    return samples, caf.desc.sample_rate
