"""Sun/NeXT AU (.au / .snd) decoding, pure NumPy.

The reference accepts any container AudioToolbox can open
(LBAudioDetective.h:210-235); Core Audio ships an AU/SND reader (kAudioFileNextType),
so the framework decodes it natively alongside CAF, WAV and AIFF.

Header (all big-endian uint32): magic ".snd", data offset, data size
(0xFFFFFFFF = unknown), encoding, sample rate, channels.  Encodings covered:
1 = G.711 mu-law, 2/3/4/5 = signed PCM 8/16/24/32-bit, 6/7 = float32/64,
27 = G.711 A-law — every non-ADPCM encoding Core Audio itself reads.
"""

from __future__ import annotations

import struct

import numpy as np

from lbaudiodetective.errors import DecodeError, UnsupportedFormatError
from lbaudiodetective.io.pcm import downmix_mean, pcm24_to_float, whole

_MAGIC = b".snd"
_UNKNOWN_SIZE = 0xFFFFFFFF


def read_au(path: str) -> tuple[np.ndarray, float]:
    """Read an AU/SND file -> (mono float32 samples in [-1,1), rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 24 or raw[:4] != _MAGIC:
        raise DecodeError("not an AU/SND file")
    data_off, data_size, enc, rate, channels = struct.unpack(
        ">IIIII", raw[4:24])
    if data_off < 24 or data_off > len(raw):
        raise DecodeError("AU data offset out of range")
    if channels < 1 or not (0 < rate < 1e7):
        raise DecodeError("invalid AU header parameters")
    data = raw[data_off:]
    if data_size != _UNKNOWN_SIZE:
        data = data[:data_size]            # tolerate trailing slack

    if enc == 1:
        from lbaudiodetective.io.g711 import decode_mulaw

        x = decode_mulaw(data)
    elif enc == 27:
        from lbaudiodetective.io.g711 import decode_alaw

        x = decode_alaw(data)
    elif enc == 2:
        x = np.frombuffer(data, np.int8).astype(np.float32) / 128.0
    elif enc == 3:
        x = np.frombuffer(whole(data, 2), ">i2").astype(np.float32) / 32768.0
    elif enc == 4:
        x = pcm24_to_float(data, little=False)
    elif enc == 5:
        x = np.frombuffer(whole(data, 4), ">i4"
                          ).astype(np.float32) / 2147483648.0
    elif enc == 6:
        x = np.frombuffer(whole(data, 4), ">f4").astype(np.float32)
    elif enc == 7:
        x = np.frombuffer(whole(data, 8), ">f8").astype(np.float32)
    else:
        raise UnsupportedFormatError(f"unsupported AU encoding {enc}")

    x = downmix_mean(x, channels)
    return np.ascontiguousarray(x, np.float32), float(rate)


def write_au(path: str, samples: np.ndarray, sample_rate: float,
             encoding: int = 3) -> None:
    """Write mono float32 samples as AU (test helper).

    encoding: 3 = 16-bit big-endian PCM (default), 1 = mu-law, 27 = A-law.
    """
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    if encoding == 3:
        payload = np.round(x * 32767.0).astype(">i2").tobytes()
    elif encoding in (1, 27):
        from lbaudiodetective.io.g711 import encode_alaw, encode_mulaw

        payload = (encode_mulaw if encoding == 1 else encode_alaw)(x)
    else:
        raise UnsupportedFormatError(f"write_au: unsupported encoding {encoding}")
    header = _MAGIC + struct.pack(">IIIII", 24, len(payload), encoding,
                                  int(sample_rate), 1)
    with open(path, "wb") as f:
        f.write(header + payload)
