"""CAF container + codec decode tests (replaces AudioToolbox decode parity)."""

import numpy as np
import pytest

from lbaudiodetective.io import caf
from tests.conftest import corpus_path


def test_parse_caf_ima4_desc():
    with open(corpus_path("BlackBird"), "rb") as f:
        parsed = caf.parse_caf(f.read())
    d = parsed.desc
    assert d.format_id == "ima4"
    assert d.sample_rate == 44100.0
    assert d.bytes_per_packet == 34
    assert d.frames_per_packet == 64
    assert d.channels_per_frame == 1
    assert parsed.valid_frames == 397046


def test_parse_caf_lpcm_desc():
    with open(corpus_path("BlackBird_rec"), "rb") as f:
        parsed = caf.parse_caf(f.read())
    d = parsed.desc
    assert d.format_id == "lpcm"
    assert d.format_flags == 2  # little-endian integer
    assert d.bits_per_channel == 32


def test_ima4_decode_reference_packet():
    """Hand-computed first steps of the IMA ADPCM recurrence."""
    # predictor = 0x0100 (256), step index = 2 -> step 9; nibbles 0x1, 0x9.
    header = (256 & 0xFF80) | 2
    body = bytes([0x91]) + bytes(31)  # low nibble 1 first, then 9
    packet = header.to_bytes(2, "big") + body
    out = caf.decode_ima4(packet)
    # n=1: diff = 9>>3 + 9>>2 = 1 + 2 = 3 -> pred 259
    assert round(out[0] * 32768) == 259
    # index 2 + index_table[1]=-1 -> 1 -> step 8; n=9: diff=-(1+2)=-3 -> 256
    assert round(out[1] * 32768) == 256


def test_ima4_decode_full_file_properties():
    x, sr = caf.read_caf(corpus_path("BlackBird"))
    assert sr == 44100.0
    assert x.dtype == np.float32
    assert x.shape[0] == 397046  # trimmed to pakt valid frames
    assert np.all(np.isfinite(x))
    rms = float(np.sqrt(np.mean(x ** 2)))
    assert 0.01 < rms < 0.8  # real audio, not noise-floor or clipped garbage
    assert np.abs(x).max() <= 1.0


def test_lpcm_decode_full_file_properties():
    x, sr = caf.read_caf(corpus_path("BlackBird_rec"))
    assert sr == 44100.0
    assert x.shape[0] == 513844 // 4
    rms = float(np.sqrt(np.mean(x ** 2)))
    assert 0.005 < rms < 0.8
    assert np.abs(x).max() <= 1.0


def test_ima4_packet_independence():
    """Packets carry their own state: decoding a suffix matches the full run."""
    with open(corpus_path("Crow"), "rb") as f:
        parsed = caf.parse_caf(f.read())
    full = caf.decode_ima4(parsed.data)
    tail = caf.decode_ima4(parsed.data[34 * 10:])
    np.testing.assert_array_equal(full[640:640 + len(tail)], tail)


def test_truncated_caf_raises():
    with pytest.raises(ValueError):
        caf.parse_caf(b"caff\x00\x01\x00\x00")  # headers but no chunks
    with pytest.raises(ValueError):
        caf.parse_caf(b"RIFF1234")  # wrong magic
