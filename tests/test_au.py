"""AU/SND decode tests (container breadth, LBAudioDetective.h:210-235)."""

import struct

import numpy as np
import pytest

from lbaudiodetective.errors import DecodeError, UnsupportedFormatError
from lbaudiodetective.io.au import read_au, write_au
from lbaudiodetective.io.decode import decode_audio_file


def _sine(n=4410, rate=44100.0, f=440.0):
    t = np.arange(n) / rate
    return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _au(tmp_path, enc, payload, rate=44100, channels=1, name="t.au",
        data_size=None):
    p = str(tmp_path / name)
    header = b".snd" + struct.pack(
        ">IIIII", 24, len(payload) if data_size is None else data_size,
        enc, rate, channels)
    with open(p, "wb") as f:
        f.write(header + payload)
    return p


def test_roundtrip_16bit(tmp_path):
    x = _sine()
    p = str(tmp_path / "tone.au")
    write_au(p, x, 44100.0)
    y, rate = read_au(p)
    assert rate == 44100.0
    assert y.shape == x.shape
    np.testing.assert_allclose(y, x, atol=1.0 / 32767.0)


def test_matches_aiff_decode_exactly(tmp_path):
    """The same 16-bit big-endian samples through AU and AIFF decode
    bit-identically, and decode_audio_file dispatches on the .snd magic."""
    from lbaudiodetective.io.aiff import write_aiff

    x = _sine()
    pu, pa = str(tmp_path / "a.au"), str(tmp_path / "a.aiff")
    write_au(pu, x, 44100.0)
    write_aiff(pa, x, 44100.0)
    yu, _ = read_au(pu)
    ya, _ = __import__("lbaudiodetective.io.aiff",
                       fromlist=["read_aiff"]).read_aiff(pa)
    np.testing.assert_array_equal(yu, ya)
    d = decode_audio_file(pu)          # dispatches on the .snd magic
    assert d.file_rate == 44100.0 and d.file_frames == len(x)


def test_encodings(tmp_path):
    x = _sine(512)
    # float32 / float64: exact round-trips.
    for enc, dt in [(6, ">f4"), (7, ">f8")]:
        p = _au(tmp_path, enc, x.astype(dt).tobytes(), name=f"f{enc}.au")
        y, _ = read_au(p)
        np.testing.assert_allclose(y, x, atol=1e-7)
    # 8-bit signed PCM.
    p = _au(tmp_path, 2, np.round(x * 127).astype(np.int8).tobytes())
    y, _ = read_au(p)
    np.testing.assert_allclose(y, x, atol=1.0 / 127.0)
    # 24-bit big-endian PCM.
    v = np.round(x * ((1 << 23) - 1)).astype(np.int32)
    b24 = np.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF],
                   axis=1).astype(np.uint8).tobytes()
    p = _au(tmp_path, 4, b24)
    y, _ = read_au(p)
    np.testing.assert_allclose(y, x, atol=1.0 / (1 << 22))
    # 32-bit big-endian PCM.
    p = _au(tmp_path, 5, np.round(x * 2147483392.0).astype(">i4").tobytes())
    y, _ = read_au(p)
    np.testing.assert_allclose(y, x, atol=1e-6)


def test_g711_matches_table_decode(tmp_path):
    """AU mu-law/A-law payloads decode through the same G.711 tables as the
    CAF/WAV/AIFF paths (bit-identical)."""
    from lbaudiodetective.io.g711 import (decode_alaw, decode_mulaw,
                                          encode_alaw, encode_mulaw)

    x = _sine(512)
    for enc, enc_fn, dec_fn in [(1, encode_mulaw, decode_mulaw),
                                (27, encode_alaw, decode_alaw)]:
        payload = enc_fn(x)
        p = _au(tmp_path, enc, payload, name=f"g{enc}.au")
        y, _ = read_au(p)
        np.testing.assert_array_equal(y, dec_fn(payload))


def test_stereo_downmix_unknown_size_and_truncation(tmp_path):
    x = _sine(64)
    st = np.stack([x, -x], axis=1).ravel()
    p = _au(tmp_path, 3, np.round(st * 32767).astype(">i2").tobytes(),
            channels=2)
    y, _ = read_au(p)
    assert y.shape == (64,)
    np.testing.assert_allclose(y, np.zeros(64), atol=1.0 / 32768.0)
    # 0xFFFFFFFF data size = "unknown": read to EOF.
    p = _au(tmp_path, 3, np.round(x * 32767).astype(">i2").tobytes(),
            data_size=0xFFFFFFFF, name="unk.au")
    y, _ = read_au(p)
    assert y.shape == (64,)
    # Ragged tail byte: trimmed, not a frombuffer crash.
    raw = open(p, "rb").read()
    p2 = str(tmp_path / "ragged.au")
    with open(p2, "wb") as f:
        f.write(raw[:-1])
    y, _ = read_au(p2)
    assert y.shape == (63,)


def test_error_paths(tmp_path):
    with pytest.raises(DecodeError):
        read_au(_au(tmp_path, 3, b"", rate=0, name="rate0.au"))
    with pytest.raises(DecodeError):
        read_au(_au(tmp_path, 3, b"", channels=0, name="ch0.au"))
    with pytest.raises(UnsupportedFormatError):
        read_au(_au(tmp_path, 23, b"\x00" * 8, name="adpcm.au"))  # G.721
    p = str(tmp_path / "short.au")
    with open(p, "wb") as f:
        f.write(b".snd\x00")
    with pytest.raises(DecodeError):
        read_au(p)
    bad_off = b".snd" + struct.pack(">IIIII", 4096, 8, 3, 44100, 1)
    p = str(tmp_path / "badoff.au")
    with open(p, "wb") as f:
        f.write(bad_off)
    with pytest.raises(DecodeError):
        read_au(p)


def test_corpus_clip_via_au_same_score(tmp_path):
    """Re-containering a corpus clip as AU must not change its match score
    (decode-path equivalence at the API level)."""
    from tests.conftest import corpus_path
    from lbaudiodetective.io.caf import read_caf
    from lbaudiodetective.models.detective import AudioDetective

    samples, rate = read_caf(corpus_path("Wren_eql"))
    p = str(tmp_path / "wren_eql.au")
    write_au(p, samples, rate)
    det = AudioDetective()
    s_caf = det.compare_audio_files(corpus_path("Wren"), corpus_path("Wren_eql"))
    s_au = det.compare_audio_files(corpus_path("Wren"), p)
    # 16-bit requantisation of an IMA4 decode perturbs scores marginally.
    assert abs(s_caf - s_au) < 0.02
