"""AIFF/AIFF-C decode tests (container breadth, LBAudioDetective.h:210-235)."""

import struct

import numpy as np
import pytest

from lbaudiodetective.errors import DecodeError, UnsupportedFormatError
from lbaudiodetective.io.aiff import (_read_extended80, _write_extended80,
                                      read_aiff, write_aiff)
from lbaudiodetective.io.decode import decode_audio_file


def _sine(n=4410, rate=44100.0, f=440.0):
    t = np.arange(n) / rate
    return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def test_extended80_roundtrip():
    for rate in (8000.0, 5512.0, 22050.0, 44100.0, 48000.0, 96000.0):
        assert _read_extended80(_write_extended80(rate)) == rate


def test_roundtrip_16bit(tmp_path):
    x = _sine()
    p = str(tmp_path / "tone.aiff")
    write_aiff(p, x, 44100.0)
    y, rate = read_aiff(p)
    assert rate == 44100.0
    assert y.shape == x.shape
    # 16-bit quantisation only.
    np.testing.assert_allclose(y, x, atol=1.0 / 32767.0)


def test_matches_wav_decode_exactly(tmp_path):
    """The same 16-bit samples through AIFF (big-endian) and WAV
    (little-endian) decode bit-identically."""
    from lbaudiodetective.io.wav import write_wav

    x = _sine()
    pa, pw = str(tmp_path / "a.aiff"), str(tmp_path / "a.wav")
    write_aiff(pa, x, 44100.0)
    write_wav(pw, x, 44100.0)
    ya, ra = read_aiff(pa)
    da = decode_audio_file(pa)          # dispatches on the FORM magic
    dw = decode_audio_file(pw)
    np.testing.assert_array_equal(da.samples, dw.samples)
    assert da.file_rate == dw.file_rate == 44100.0
    assert da.file_frames == dw.file_frames == len(x)
    np.testing.assert_array_equal(ya, np.frombuffer(
        np.round(np.clip(x, -1, 1) * 32767.0).astype(">i2").tobytes(),
        ">i2").astype(np.float32) / 32768.0)
    assert ra == 44100.0


def _aifc(tmp_path, comp: bytes, data: bytes, bits: int, frames: int,
          channels: int = 1, rate: float = 44100.0) -> str:
    comm = (b"COMM" + struct.pack(">IHIH", 22 + 2, channels, frames, bits)
            + _write_extended80(rate) + comp + b"\x00\x00")
    ssnd = b"SSND" + struct.pack(">III", 8 + len(data), 0, 0) + data
    if len(data) & 1:
        ssnd += b"\x00"
    body = b"AIFC" + comm + ssnd
    p = str(tmp_path / f"t_{comp.decode()}.aifc")
    with open(p, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)
    return p


def test_aifc_sowt_and_fl32(tmp_path):
    x = _sine(1024)
    pcm = np.round(x * 32767.0).astype("<i2")
    p = _aifc(tmp_path, b"sowt", pcm.tobytes(), 16, len(x))
    y, _ = read_aiff(p)
    np.testing.assert_allclose(y, pcm.astype(np.float32) / 32768.0)
    p = _aifc(tmp_path, b"fl32", x.astype(">f4").tobytes(), 32, len(x))
    y, _ = read_aiff(p)
    np.testing.assert_array_equal(y, x)


def test_stereo_downmix_and_frame_cap(tmp_path):
    x = _sine(512)
    stereo = np.stack([x, -x], axis=1).ravel()      # downmix -> zeros
    pcm = np.round(stereo * 32767.0).astype(">i2")
    p = _aifc(tmp_path, b"NONE", pcm.tobytes(), 16, 512, channels=2)
    y, _ = read_aiff(p)
    assert y.shape == (512,)
    assert np.abs(y).max() <= 1.0 / 32768.0         # +-1 LSB rounding residue


def test_error_paths(tmp_path):
    p = str(tmp_path / "bad.aiff")
    with open(p, "wb") as f:
        f.write(b"FORM\x00\x00\x00\x04JUNK")
    with pytest.raises(DecodeError):
        read_aiff(p)
    x = _sine(64)
    pcm = np.round(x * 32767).astype(">i2")
    p = _aifc(tmp_path, b"ima4", pcm.tobytes(), 16, 64)
    with pytest.raises(UnsupportedFormatError):
        read_aiff(p)
    # Truncated SSND tolerated (fault-injection posture of io/wav.py).
    full = _aifc(tmp_path, b"NONE", pcm.tobytes(), 16, 64)
    raw = open(full, "rb").read()
    p2 = str(tmp_path / "trunc.aiff")
    with open(p2, "wb") as f:
        f.write(raw[:len(raw) - 40])
    y, _ = read_aiff(p2)
    assert 0 < y.shape[0] < 64


def test_corpus_clip_via_aiff_same_score(tmp_path):
    """Re-containering a corpus clip as AIFF must not change its match
    score (decode-path equivalence at the API level)."""
    from tests.conftest import corpus_path
    from lbaudiodetective.io.caf import read_caf
    from lbaudiodetective.models.detective import AudioDetective

    samples, rate = read_caf(corpus_path("Wren_eql"))
    p = str(tmp_path / "wren_eql.aiff")
    write_aiff(p, samples, rate)
    det = AudioDetective()
    s_caf = det.compare_audio_files(corpus_path("Wren"), corpus_path("Wren_eql"))
    s_aiff = det.compare_audio_files(corpus_path("Wren"), p)
    # 16-bit requantisation of an IMA4 decode perturbs scores marginally.
    assert abs(s_caf - s_aiff) < 0.02


def test_ragged_tail_truncation(tmp_path):
    """A file cut mid-sample must decode (trimmed), not crash frombuffer."""
    x = _sine(64)
    pcm = np.round(x * 32767).astype(">i2")
    full = _aifc(tmp_path, b"NONE", pcm.tobytes(), 16, 64)
    raw = open(full, "rb").read()
    p = str(tmp_path / "ragged.aiff")
    with open(p, "wb") as f:
        f.write(raw[:len(raw) - 41])            # odd-byte cut
    y, _ = read_aiff(p)
    assert 0 < y.shape[0] < 64

    from lbaudiodetective.io.wav import read_wav, write_wav

    pw = str(tmp_path / "full.wav")
    write_wav(pw, x, 44100.0)
    raw = open(pw, "rb").read()
    p2 = str(tmp_path / "ragged.wav")
    with open(p2, "wb") as f:
        f.write(raw[:len(raw) - 13])
    y, _ = read_wav(p2)
    assert 0 < y.shape[0] < 64
