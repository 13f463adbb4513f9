"""WAV decode: roundtrip, formats, and end-to-end equivalence with CAF."""

import numpy as np
import pytest

from lbaudiodetective.io import caf
from lbaudiodetective.io.decode import decode_audio_file
from lbaudiodetective.io.wav import read_wav, write_wav
from lbaudiodetective.models.detective import AudioDetective
from tests.conftest import corpus_path


def test_wav_roundtrip_16bit(tmp_path):
    rng = np.random.default_rng(95)
    x = (rng.standard_normal(5000) * 0.3).clip(-1, 1).astype(np.float32)
    p = str(tmp_path / "t.wav")
    write_wav(p, x, 8000)
    y, sr = read_wav(p)
    assert sr == 8000.0
    np.testing.assert_allclose(y, x, atol=2.0 / 32768)


def test_wav_float32(tmp_path):
    import struct

    x = np.linspace(-0.5, 0.5, 1000).astype(np.float32)
    pcm = x.astype("<f4").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 44100, 44100 * 4, 4, 32)
           + b"data" + struct.pack("<I", len(pcm)) + pcm)
    p = tmp_path / "f32.wav"
    p.write_bytes(hdr)
    y, sr = read_wav(str(p))
    np.testing.assert_array_equal(y, x)


def _extensible_wav(tmp_path, name, subformat_code, bits, pcm):
    import struct

    # WAVE_FORMAT_EXTENSIBLE: 16-byte base fmt + cbSize(22) + validBits +
    # channelMask + 16-byte SubFormat GUID (first 2 bytes = format code).
    guid = struct.pack("<H", subformat_code) + b"\x00\x00" + bytes(
        [0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71])
    fmt = struct.pack("<HHIIHH", 0xFFFE, 1, 44100, 44100 * (bits // 8),
                      bits // 8, bits) + struct.pack("<HHI", 22, bits, 4) + guid
    hdr = (b"RIFF" + struct.pack("<I", 36 + 24 + len(pcm)) + b"WAVE"
           + b"fmt " + struct.pack("<I", len(fmt)) + fmt
           + b"data" + struct.pack("<I", len(pcm)) + pcm)
    p = tmp_path / name
    p.write_bytes(hdr)
    return str(p)


def test_wav_extensible_float32_guid(tmp_path):
    """An EXTENSIBLE 32-bit IEEE-float WAV must decode as float (SubFormat
    GUID code 3), not be guessed as int32 PCM from the bit depth."""
    x = np.linspace(-0.5, 0.5, 1000).astype(np.float32)
    p = _extensible_wav(tmp_path, "ext_f32.wav", 3, 32, x.astype("<f4").tobytes())
    y, sr = read_wav(p)
    np.testing.assert_array_equal(y, x)


def test_wav_extensible_int32_guid(tmp_path):
    x = np.linspace(-0.5, 0.5, 1000)
    ints = np.round(x * 2147483647).astype("<i4")
    p = _extensible_wav(tmp_path, "ext_i32.wav", 1, 32, ints.tobytes())
    y, sr = read_wav(p)
    np.testing.assert_allclose(y, x, atol=1e-6)


def test_wav_extensible_unknown_subformat_raises(tmp_path):
    p = _extensible_wav(tmp_path, "ext_bad.wav", 0xFFFA, 32, b"\x00" * 64)
    with pytest.raises(NotImplementedError):
        read_wav(p)


def test_wav_stereo_downmix(tmp_path):
    import struct

    left = np.full(100, 0.5, np.float32)
    right = np.full(100, -0.25, np.float32)
    inter = np.empty(200, np.float32)
    inter[0::2], inter[1::2] = left, right
    pcm = (inter * 32767).astype("<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 22050, 22050 * 4, 4, 16)
           + b"data" + struct.pack("<I", len(pcm)) + pcm)
    p = tmp_path / "st.wav"
    p.write_bytes(hdr)
    y, sr = read_wav(str(p))
    assert y.shape == (100,)
    np.testing.assert_allclose(y, 0.125, atol=1e-3)


def test_wav_clip_matches_caf_fingerprint(tmp_path):
    """Transcode a corpus clip to WAV; fingerprints must match ~exactly."""
    x, sr = caf.read_caf(corpus_path("Sparrow"))
    p = str(tmp_path / "sparrow.wav")
    write_wav(p, x, sr)
    det = AudioDetective()
    fp_caf = det.process_audio_file(corpus_path("Sparrow"))
    fp_wav = det.process_audio_file(p)
    assert fp_wav.num_subfingerprints == fp_caf.num_subfingerprints
    # 16-bit requantisation flips at most a tiny fraction of rank-boundary bits.
    agree = (fp_wav.pos == fp_caf.pos).mean()
    assert agree > 0.98
    assert det.compare_fingerprints(fp_caf, fp_wav) > 0.97


def test_bad_wav_raises(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"RIFFxxxxWAVE")
    with pytest.raises(ValueError):
        read_wav(str(p))
