"""Native C++ decoder/resampler vs the NumPy reference implementations."""

import numpy as np
import pytest

from lbaudiodetective.io import caf
from lbaudiodetective.io.native import binding as native
from lbaudiodetective.io.resample import design_polyphase_bank
from tests.conftest import corpus_path

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native decoder not built")


@pytest.mark.parametrize("name", ["BlackBird", "Crow", "BlackBird_rec"])
def test_native_decode_matches_numpy(name):
    x_np, sr_np = caf.read_caf(corpus_path(name))
    x_c, sr_c = native.read_caf(corpus_path(name))
    assert sr_c == sr_np
    assert x_c.shape == x_np.shape
    np.testing.assert_array_equal(x_c, x_np)  # integer DSP: bit-exact


def test_native_resample_matches_numpy():
    from lbaudiodetective.io.resample import polyphase_plan

    rng = np.random.default_rng(40)
    x = (rng.standard_normal(44100) * 0.3).astype(np.float32)
    up, down = 1378, 11025
    bank = design_polyphase_bank(up, down)
    # NumPy path (bypassing the native fast path inside resample_rational).
    n_out, base, phase = polyphase_plan(len(x), up, down, bank)
    taps = bank.shape[1]
    xp = np.concatenate([np.zeros(taps, np.float32), x, np.zeros(taps, np.float32)])
    idx = (base + taps)[:, None] + np.arange(taps)[None, :]
    expected = np.einsum("nt,nt->n", xp[idx], bank[phase]).astype(np.float32)
    got = native.resample(x, bank, up, down)
    np.testing.assert_allclose(got, expected, atol=2e-6)


def test_native_decode_error_paths(tmp_path):
    bad = tmp_path / "bad.caf"
    bad.write_bytes(b"RIFFnotacaf")
    with pytest.raises(ValueError):
        native.read_caf(str(bad))
    with pytest.raises(ValueError):
        native.read_caf(str(tmp_path / "missing.caf"))


def _tone(n=2048, rate=8000.0):
    t = np.arange(n) / rate
    return (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)


def test_native_read_audio_dispatches_all_containers(tmp_path):
    """lbad_read_audio decodes WAV/AIFF/AU/CAF bit-identically to the NumPy
    readers (mono integer payloads: exact)."""
    from lbaudiodetective.io.aiff import read_aiff, write_aiff
    from lbaudiodetective.io.au import read_au, write_au
    from lbaudiodetective.io.wav import read_wav, write_wav

    x = _tone()
    cases = [("t.wav", write_wav, read_wav), ("t.aiff", write_aiff, read_aiff),
             ("t.au", write_au, read_au)]
    for name, writer, reader in cases:
        p = str(tmp_path / name)
        writer(p, x, 8000.0)
        y_np, r_np = reader(p)
        y_c, r_c = native.read_audio(p)
        assert r_c == r_np == 8000.0
        np.testing.assert_array_equal(y_c, y_np)
    # CAF through the same entry.
    y_np, r_np = caf.read_caf(corpus_path("BlackBird"))
    y_c, r_c = native.read_audio(corpus_path("BlackBird"))
    assert r_c == r_np
    np.testing.assert_array_equal(y_c, y_np)


def test_native_read_audio_codec_matrix(tmp_path):
    """Float/G.711/24-bit payloads across containers: native == NumPy."""
    import struct

    from lbaudiodetective.io.au import read_au
    from lbaudiodetective.io.g711 import encode_mulaw
    from lbaudiodetective.io.wav import read_wav

    x = _tone(512)
    # WAV float32.
    pcm = x.astype("<f4").tobytes()
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 8000, 32000, 4, 32)
    body = b"WAVE" + fmt + b"data" + struct.pack("<I", len(pcm)) + pcm
    p = str(tmp_path / "f32.wav")
    open(p, "wb").write(b"RIFF" + struct.pack("<I", len(body)) + body)
    np.testing.assert_array_equal(native.read_audio(p)[0], read_wav(p)[0])
    # WAV G.711 mu-law.
    payload = encode_mulaw(x)
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 7, 1, 8000, 8000, 1, 8)
    body = b"WAVE" + fmt + b"data" + struct.pack("<I", len(payload)) + payload
    p = str(tmp_path / "ulaw.wav")
    open(p, "wb").write(b"RIFF" + struct.pack("<I", len(body)) + body)
    np.testing.assert_array_equal(native.read_audio(p)[0], read_wav(p)[0])
    # WAV 24-bit PCM.
    v = np.round(x.astype(np.float64) * ((1 << 23) - 1)).astype(np.int32)
    b24 = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                   axis=1).astype(np.uint8).tobytes()
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 24000, 3, 24)
    body = b"WAVE" + fmt + b"data" + struct.pack("<I", len(b24)) + b24
    p = str(tmp_path / "p24.wav")
    open(p, "wb").write(b"RIFF" + struct.pack("<I", len(body)) + body)
    np.testing.assert_array_equal(native.read_audio(p)[0], read_wav(p)[0])
    # AU 24-bit BE + f64 + A-law.
    from lbaudiodetective.io.au import write_au

    for enc, name in [(1, "g1.au"), (27, "g27.au")]:
        p = str(tmp_path / name)
        write_au(p, x, 8000.0, encoding=enc)
        np.testing.assert_array_equal(native.read_audio(p)[0], read_au(p)[0])
    b24 = np.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF],
                   axis=1).astype(np.uint8).tobytes()
    p = str(tmp_path / "p24.au")
    open(p, "wb").write(b".snd" + struct.pack(">IIIII", 24, len(b24), 4,
                                              8000, 1) + b24)
    np.testing.assert_array_equal(native.read_audio(p)[0], read_au(p)[0])
    f64 = x.astype(">f8").tobytes()
    p = str(tmp_path / "f64.au")
    open(p, "wb").write(b".snd" + struct.pack(">IIIII", 24, len(f64), 7,
                                              8000, 1) + f64)
    np.testing.assert_array_equal(native.read_audio(p)[0], read_au(p)[0])


def test_native_read_audio_stereo_close_to_numpy(tmp_path):
    """Stereo downmix: the C++ path averages in double, NumPy in float32 —
    equal to 1 ulp, not guaranteed bit-exact."""
    import struct

    from lbaudiodetective.io.wav import read_wav

    x = _tone(256)
    st = np.stack([x, 0.5 * x], axis=1).ravel()
    pcm = np.round(st * 32767.0).astype("<i2").tobytes()
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 8000, 32000, 4, 16)
    body = b"WAVE" + fmt + b"data" + struct.pack("<I", len(pcm)) + pcm
    p = str(tmp_path / "st.wav")
    open(p, "wb").write(b"RIFF" + struct.pack("<I", len(body)) + body)
    np.testing.assert_allclose(native.read_audio(p)[0], read_wav(p)[0],
                               atol=1e-7)


def test_stale_prebuilt_so_triggers_rebuild(tmp_path, monkeypatch):
    """A prebuilt .so missing newer exports must be rebuilt, not silently
    disable the whole native path (the blanket except in _load would turn
    the AttributeError into available() == False forever)."""
    import pathlib
    import shutil

    from lbaudiodetective.io.au import write_au
    from lbaudiodetective.io.native import binding as b

    src = pathlib.Path(b.__file__).resolve().parent
    work = tmp_path / "native"
    shutil.copytree(src, work,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (work / "build").mkdir()
    # A "stale" library: valid ELF bytes whose export strings lack the new
    # symbol (mangle the name in place, same length).
    blob = (src / "build" / "libcaf_decoder.so").read_bytes()
    assert b"lbad_read_audio" in blob
    (work / "build" / "libcaf_decoder.so").write_bytes(
        blob.replace(b"lbad_read_audio", b"lbad_read_zzzzz"))
    monkeypatch.setattr(b, "_SO", work / "build" / "libcaf_decoder.so")
    monkeypatch.setattr(b, "_DIR", work)
    monkeypatch.setattr(b, "_lib", None)
    monkeypatch.setattr(b, "_tried", False)
    assert b.available()                   # detected stale, rebuilt via make
    p = str(tmp_path / "t.au")
    write_au(p, _tone(64), 8000.0)
    y, rate = b.read_audio(p)
    assert rate == 8000.0 and y.shape == (64,)


def test_native_read_audio_falls_back_for_adpcm(tmp_path):
    """IMA-ADPCM WAV is NumPy-only: native raises, decode_audio_file still
    decodes it (fallback path)."""
    import struct

    from lbaudiodetective.io.decode import decode_audio_file

    # Minimal 1-block mono IMA ADPCM WAV (predictor 1000, all-zero nibbles).
    block = struct.pack("<hBB", 1000, 0, 0) + b"\x00" * 32
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 0x11, 1, 8000, 4000, len(block), 4)
    body = (b"WAVE" + fmt + b"fact" + struct.pack("<II", 4, 65)
            + b"data" + struct.pack("<I", len(block)) + block)
    p = str(tmp_path / "ima.wav")
    open(p, "wb").write(b"RIFF" + struct.pack("<I", len(body)) + body)
    with pytest.raises(ValueError):
        native.read_audio(p)
    d = decode_audio_file(p)
    assert d.samples.dtype == np.float32 and d.file_frames == 65
