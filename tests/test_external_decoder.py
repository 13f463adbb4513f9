"""External-decoder shim (io/external.py): perceptual-codec breadth parity.

The reference decodes anything AudioToolbox opens (MP3/AAC/ALAC on iOS,
LBAudioDetective.m:224); our built-in codecs cover CAF/WAV/AIFF/AU.  The
shim routes unknown containers through a system ffmpeg when present and
raises typed errors otherwise.  Tests run with a MOCKED decoder (the CI
image has no ffmpeg); the live test is skip-marked on availability.
"""

import sys

import numpy as np
import pytest

from lbaudiodetective.errors import (DecodeError, UnsupportedFormatError)
from lbaudiodetective.io import external
from lbaudiodetective.io.decode import decode_audio_file


@pytest.fixture(autouse=True)
def reset_decoder_cache():
    old = external._cached
    yield
    external._cached = old


def _fake_mp3(tmp_path):
    p = tmp_path / "song.mp3"
    p.write_bytes(b"ID3\x04\x00\x00\x00\x00\x00\x00" + b"\xff\xfb" + b"\x00" * 500)
    return str(p)


def test_unknown_magic_without_decoder_raises_typed(tmp_path, monkeypatch):
    monkeypatch.setattr(external, "_cached", None)   # probed: none found
    with pytest.raises(UnsupportedFormatError):
        decode_audio_file(_fake_mp3(tmp_path))


def test_mocked_decoder_roundtrip(tmp_path, monkeypatch):
    """A stand-in 'decoder' (a child python writing a known sine WAV) must
    flow through decode_audio_file: transcode -> our WAV reader -> resample."""
    script = (
        "import sys, numpy as np\n"
        "from lbaudiodetective.io.wav import write_wav\n"
        "x = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(22050) / 22050.0)"
        ").astype(np.float32)\n"
        "write_wav(sys.argv[2], x, 22050.0)\n"
    )

    def build(src, dst):
        return [sys.executable, "-c", script, src, dst]

    monkeypatch.setattr(external, "_cached", ("fake", build))
    d = decode_audio_file(_fake_mp3(tmp_path))
    assert d.file_rate == 22050.0
    assert d.processing_rate == 5512.0
    assert d.file_frames == 22050
    assert d.samples.dtype == np.float32
    # 1 second of audio at the processing rate (rational resample 1/4).
    assert abs(d.samples.shape[0] - 5512) <= 2


def test_decoder_failure_raises_decode_error(tmp_path, monkeypatch):
    def build(src, dst):
        return [sys.executable, "-c",
                "import sys; sys.stderr.write('bad stream'); sys.exit(1)"]

    monkeypatch.setattr(external, "_cached", ("fake", build))
    with pytest.raises(DecodeError, match="bad stream"):
        decode_audio_file(_fake_mp3(tmp_path))


def test_known_containers_never_hit_the_shim(tmp_path, monkeypatch):
    """CAF/WAV/AIFF/AU decode with the built-in codecs even when the shim
    would fail loudly — the external path is only for unknown magic."""
    def explode(path, timeout_s=0):
        raise AssertionError("external shim must not be called")

    monkeypatch.setattr(external, "decode_via_external", explode)
    from tests.conftest import corpus_path

    d = decode_audio_file(corpus_path("Wren_eql"))
    assert d.samples.size > 0


@pytest.mark.skipif(not external.available(),
                    reason="no system ffmpeg/avconv installed")
def test_live_external_decoder_roundtrip(tmp_path):
    """With a real ffmpeg: WAV -> MP3 -> shim decode, content must survive
    (high correlation; MP3 is lossy so not bit-exact)."""
    import subprocess

    from lbaudiodetective.io.wav import write_wav

    rng = np.random.default_rng(0)
    t = np.arange(44100) / 44100.0
    x = (0.4 * np.sin(2 * np.pi * 880.0 * t)
         + 0.05 * rng.standard_normal(44100)).astype(np.float32)
    src = tmp_path / "in.wav"
    write_wav(str(src), x, 44100.0)
    mp3 = tmp_path / "in.mp3"
    name, _ = external.find_external_decoder()
    subprocess.run([name, "-v", "error", "-y", "-i", str(src), str(mp3)],
                   check=True, timeout=120)
    d = decode_audio_file(str(mp3))
    ref = decode_audio_file(str(src))
    n = min(d.samples.shape[0], ref.samples.shape[0])
    a, b = d.samples[:n], ref.samples[:n]
    corr = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert corr > 0.9
