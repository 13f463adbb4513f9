"""Fault-injection fixtures (SURVEY §5: corrupt-CAF and truncated-stream).

The reference logs OSStatus errors to stderr and continues
(LBAudioDetective.m:53-72); here malformed inputs raise typed errors and
truncated-but-parseable inputs degrade gracefully (shorter fingerprints)."""

import numpy as np
import pytest

from lbaudiodetective.io import caf
from lbaudiodetective.io.decode import decode_audio_file
from lbaudiodetective.models.detective import AudioDetective
from tests.conftest import corpus_path


def _read_reference_bytes(name):
    with open(corpus_path(name), "rb") as f:
        return f.read()


def test_truncated_data_chunk_decodes_prefix(tmp_path):
    """A CAF cut mid-data still decodes the packets that survived."""
    raw = _read_reference_bytes("BlackBird")
    cut = tmp_path / "cut.caf"
    cut.write_bytes(raw[: len(raw) // 2])
    full, sr = caf.read_caf(corpus_path("BlackBird"))
    part, sr2 = caf.read_caf(str(cut))
    assert sr2 == sr
    assert 0 < part.shape[0] < full.shape[0]
    # Decoded prefix must agree (packets are independent).
    n = (part.shape[0] // 64) * 64
    np.testing.assert_array_equal(part[:n], full[:n])


def test_truncated_clip_fingerprints_shorter(tmp_path):
    raw = _read_reference_bytes("Crow")
    cut = tmp_path / "crow_cut.caf"
    cut.write_bytes(raw[: len(raw) // 2])
    det = AudioDetective()
    fp_full = det.process_audio_file(corpus_path("Crow"))
    fp_cut = det.process_audio_file(str(cut))
    assert 0 < fp_cut.num_subfingerprints < fp_full.num_subfingerprints
    # The surviving prefix still matches the full clip strongly.
    assert det.compare_fingerprints(fp_full, fp_cut) > 0.9


def test_garbage_bytes_raise(tmp_path):
    bad = tmp_path / "bad.caf"
    bad.write_bytes(b"\x00" * 256)
    with pytest.raises(ValueError):
        decode_audio_file(str(bad))


def test_empty_audio_produces_empty_fingerprint(tmp_path):
    """A clip shorter than one frame yields an empty fingerprint, and
    comparing against it scores 0 (reference: imageWidth < 128 -> no loop)."""
    from lbaudiodetective.io.caf import IMA4_PACKET_BYTES
    import struct

    # Minimal valid CAF with one IMA4 packet (64 frames ~ 1.5 ms).
    desc = struct.pack(">dIIIIII", 44100.0, int.from_bytes(b"ima4", "big"),
                       0, 34, 64, 1, 0)
    data = b"\x00" * 4 + b"\x00" * IMA4_PACKET_BYTES
    raw = (b"caff\x00\x01\x00\x00"
           + b"desc" + struct.pack(">q", 32) + desc
           + b"data" + struct.pack(">q", len(data)) + data)
    tiny = tmp_path / "tiny.caf"
    tiny.write_bytes(raw)
    det = AudioDetective()
    fp = det.process_audio_file(str(tiny))
    assert fp.num_subfingerprints == 0
    real = det.process_audio_file(corpus_path("Wren"))
    assert det.compare_fingerprints(real, fp) == 0.0
    assert det.compare_fingerprints(fp, real) == 0.0


def test_fuzz_truncation_and_mutation_all_containers(tmp_path):
    """Every container reader, fed truncations at arbitrary offsets and
    random byte mutations of valid files, must either decode (float32
    output) or raise a typed AudioDetectiveError — never leak a raw
    struct.error / IndexError / ValueError from the parser internals."""
    import struct

    from lbaudiodetective.errors import AudioDetectiveError
    from lbaudiodetective.io.aiff import write_aiff
    from lbaudiodetective.io.g711 import encode_mulaw
    from lbaudiodetective.io.wav import write_wav

    rng = np.random.default_rng(99)
    x = (0.4 * np.sin(2 * np.pi * 440.0 *
                      np.arange(4000) / 8000.0)).astype(np.float32)

    samples = {}
    p = tmp_path / "t.wav"
    write_wav(str(p), x, 8000.0)
    samples["wav_pcm"] = p.read_bytes()
    p = tmp_path / "t.aiff"
    write_aiff(str(p), x, 8000.0)
    samples["aiff"] = p.read_bytes()
    payload = encode_mulaw(x)
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 7, 1, 8000, 8000, 1, 8)
    data = b"data" + struct.pack("<I", len(payload)) + payload
    body = b"WAVE" + fmt + data
    samples["wav_ulaw"] = b"RIFF" + struct.pack("<I", len(body)) + body
    samples["caf_ima4"] = open(corpus_path("Wren_eql"), "rb").read()
    from lbaudiodetective.io.au import write_au
    p = tmp_path / "t.au"
    write_au(str(p), x, 8000.0)
    samples["au_pcm"] = p.read_bytes()

    def run_one(name, blob, i):
        f = tmp_path / f"fz_{name}_{i}"
        f.write_bytes(blob)
        try:
            out, rate = {
                "wav_pcm": _wav, "wav_ulaw": _wav,
                "aiff": _aiff, "caf_ima4": _caf_read, "au_pcm": _au,
            }[name](str(f))
        except AudioDetectiveError:
            return
        assert out.dtype == np.float32

    from lbaudiodetective.io.aiff import read_aiff as _aiff
    from lbaudiodetective.io.au import read_au as _au
    from lbaudiodetective.io.wav import read_wav as _wav
    _caf_read = caf.read_caf

    for name, blob in samples.items():
        # Truncation: EVERY offset through the header region (the narrow
        # windows where struct unpacks can starve) + a spread over the rest.
        cuts = list(range(0, min(120, len(blob)))) + list(
            np.linspace(120, len(blob) - 1, 30).astype(int))
        for i, cut in enumerate(cuts):
            run_one(name, blob[:cut], i)
        # 40 random single/multi-byte mutations (headers included).
        for i in range(40):
            mutated = bytearray(blob)
            for _ in range(int(rng.integers(1, 8))):
                mutated[int(rng.integers(0, len(blob)))] = int(rng.integers(256))
            run_one(name, bytes(mutated), 1000 + i)


def _native_fuzz_corpus(tmp_path):
    """Write the same truncation/mutation corpus the Python-reader fuzz uses
    (plus crafted zero-channel / tiny-bits CAF descs) as files on disk."""
    import struct

    from lbaudiodetective.io.aiff import write_aiff
    from lbaudiodetective.io.au import write_au
    from lbaudiodetective.io.g711 import encode_mulaw
    from lbaudiodetective.io.wav import write_wav

    rng = np.random.default_rng(99)
    x = (0.4 * np.sin(2 * np.pi * 440.0 *
                      np.arange(4000) / 8000.0)).astype(np.float32)
    samples = {}
    p = tmp_path / "t.wav"
    write_wav(str(p), x, 8000.0)
    samples["wav_pcm"] = p.read_bytes()
    p = tmp_path / "t.aiff"
    write_aiff(str(p), x, 8000.0)
    samples["aiff"] = p.read_bytes()
    payload = encode_mulaw(x)
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 7, 1, 8000, 8000, 1, 8)
    data = b"data" + struct.pack("<I", len(payload)) + payload
    body = b"WAVE" + fmt + data
    samples["wav_ulaw"] = b"RIFF" + struct.pack("<I", len(body)) + body
    samples["caf_ima4"] = open(corpus_path("Wren_eql"), "rb").read()
    p = tmp_path / "t.au"
    write_au(str(p), x, 8000.0)
    samples["au_pcm"] = p.read_bytes()

    fdir = tmp_path / "native_fuzz"
    fdir.mkdir()
    count = 0
    for name, blob in samples.items():
        cuts = list(range(0, min(120, len(blob)))) + list(
            np.linspace(120, len(blob) - 1, 30).astype(int))
        for i, cut in enumerate(cuts):
            (fdir / f"{name}_cut{i}").write_bytes(blob[:cut])
            count += 1
        for i in range(40):
            mutated = bytearray(blob)
            for _ in range(int(rng.integers(1, 8))):
                mutated[int(rng.integers(0, len(blob)))] = int(rng.integers(256))
            (fdir / f"{name}_mut{i}").write_bytes(bytes(mutated))
            count += 1

    # Crafted CAF descs with file-controlled division-operand fields: the
    # channels=0 lpcm case SIGFPE'd the whole process before the guard in
    # caf_decoder.cpp (read_caf_buffer lpcm branch / decode_lpcm).
    def crafted_caf(fmt4, flags, bits, channels):
        desc = struct.pack(">d4sIIIII", 44100.0, fmt4, flags, 4, 1,
                           channels, bits)
        payload = struct.pack(">I", 0) + b"\x00" * 64
        return (b"caff\x00\x01\x00\x00"
                + b"desc" + struct.pack(">q", len(desc)) + desc
                + b"data" + struct.pack(">q", len(payload)) + payload)

    crafted = [
        (b"lpcm", 0, 16, 0),    # channels=0 -> SIGFPE pre-fix
        (b"lpcm", 0, 0, 1),     # bits=0
        (b"lpcm", 0, 4, 1),     # bits<8 -> bytes=0
        (b"lpcm", 1, 16, 1),    # float flag with non-float width
        (b"lpcm", 0, 24, 0xFFFFFFFF),
        (b"ulaw", 0, 8, 0),
        (b"alaw", 0, 8, 0),
    ]
    for i, args in enumerate(crafted):
        (fdir / f"caf_crafted{i}").write_bytes(crafted_caf(*args))
        count += 1
    return fdir, count


def test_native_decoder_fuzz_subprocess(tmp_path):
    """Run the fuzz corpus through the C++ lbad_read_audio in a subprocess:
    a signal-death (SIGFPE/SIGSEGV in the native code) surfaces as a failed
    returncode here instead of killing the test runner.  This is the path
    production decode hits FIRST (io/decode.py::_read_file), so it must be
    at least as hardened as the NumPy readers."""
    import subprocess
    import sys

    from lbaudiodetective.io.native import binding

    if not binding.available():
        pytest.skip("native decoder not built")

    fdir, count = _native_fuzz_corpus(tmp_path)
    worker = (
        "import pathlib, sys\n"
        "from lbaudiodetective.io.native import binding\n"
        "from lbaudiodetective.errors import AudioDetectiveError\n"
        "import numpy as np\n"
        "fdir = pathlib.Path(sys.argv[1])\n"
        "n = ok = 0\n"
        "for f in sorted(fdir.iterdir()):\n"
        "    n += 1\n"
        "    try:\n"
        "        out, rate = binding.read_audio(str(f))\n"
        "    except AudioDetectiveError:\n"
        "        continue\n"
        "    assert out.dtype == np.float32, f\n"
        "    ok += 1\n"
        "print(f'FUZZED {n} decoded {ok}')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", worker, str(fdir)],
        capture_output=True, text=True, timeout=300,
    )
    # returncode < 0 == died by signal: the exact failure mode this guards.
    assert proc.returncode == 0, (
        f"native fuzz worker rc={proc.returncode} "
        f"(negative = signal death)\nstderr:\n{proc.stderr[-2000:]}")
    assert f"FUZZED {count} " in proc.stdout


def test_fuzz_decode_audio_file_level(tmp_path):
    """The public decode entry (decode + resample) under header mutations:
    typed errors or a sane DecodedAudio, never parser leaks or unbounded
    resample output (corrupt sample rates are rejected by range)."""
    import struct

    from lbaudiodetective.errors import AudioDetectiveError
    from lbaudiodetective.io.wav import write_wav

    rng = np.random.default_rng(7)
    x = (0.4 * np.sin(2 * np.pi * 440.0 *
                      np.arange(4000) / 8000.0)).astype(np.float32)
    p = tmp_path / "t.wav"
    write_wav(str(p), x, 8000.0)
    blob = bytearray(p.read_bytes())
    for i in range(30):
        mutated = bytearray(blob)
        # Target the header region specifically (rate/format fields).
        for _ in range(int(rng.integers(1, 4))):
            mutated[int(rng.integers(0, 44))] = int(rng.integers(256))
        f = tmp_path / f"m{i}.wav"
        f.write_bytes(bytes(mutated))
        try:
            d = decode_audio_file(str(f))
        except AudioDetectiveError:
            continue
        assert d.samples.dtype == np.float32
        assert d.samples.shape[0] <= 60 * 5512   # bounded output
