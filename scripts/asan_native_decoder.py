"""AddressSanitizer harness for the native C++ decoder (no JAX import).

Exercises lbad_read_audio / lbad_read_caf / lbad_resample in-process on the
real corpus plus the same truncation/mutation/crafted-desc fuzz corpus as
tests/test_fault_injection.py, so heap errors in the C++ surface as ASAN
reports instead of delayed SIGSEGVs elsewhere in the process (e.g. inside a
later XLA compile).

Usage (library must be built with -fsanitize=address):
    make -B -C lbaudiodetective/io/native CXXFLAGS="-O1 -g \
        -fsanitize=address -fPIC -shared -std=c++17 -Wall"
    LD_PRELOAD=$(gcc -print-file-name=libasan.so) \
        ASAN_OPTIONS=detect_leaks=0 python scripts/asan_native_decoder.py

A clean run prints ASAN-NATIVE-OK and exits 0; any heap error aborts with an
ASAN report.
"""

import pathlib
import struct
import sys
import tempfile

import numpy as np

sys.path.insert(0, "/root/repo")

from lbaudiodetective.errors import AudioDetectiveError  # noqa: E402
from lbaudiodetective.io.aiff import write_aiff  # noqa: E402
from lbaudiodetective.io.au import write_au  # noqa: E402
from lbaudiodetective.io.g711 import encode_mulaw  # noqa: E402
from lbaudiodetective.io.native import binding  # noqa: E402
from lbaudiodetective.io.wav import write_wav  # noqa: E402

CORPUS = pathlib.Path("/root/reference/LBAudioDetectiveTests/Birds")


def corpus_files():
    return sorted(CORPUS.rglob("*.caf")) if CORPUS.exists() else []


def build_fuzz_corpus(tmp: pathlib.Path) -> list[pathlib.Path]:
    rng = np.random.default_rng(99)
    x = (0.4 * np.sin(2 * np.pi * 440.0 *
                      np.arange(4000) / 8000.0)).astype(np.float32)
    samples = {}
    p = tmp / "t.wav"
    write_wav(str(p), x, 8000.0)
    samples["wav_pcm"] = p.read_bytes()
    p = tmp / "t.aiff"
    write_aiff(str(p), x, 8000.0)
    samples["aiff"] = p.read_bytes()
    payload = encode_mulaw(x)
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 7, 1, 8000, 8000, 1, 8)
    data = b"data" + struct.pack("<I", len(payload)) + payload
    body = b"WAVE" + fmt + data
    samples["wav_ulaw"] = b"RIFF" + struct.pack("<I", len(body)) + body
    caf_src = corpus_files()
    if caf_src:
        samples["caf_ima4"] = caf_src[0].read_bytes()
    p = tmp / "t.au"
    write_au(str(p), x, 8000.0)
    samples["au_pcm"] = p.read_bytes()

    fdir = tmp / "native_fuzz"
    fdir.mkdir()
    for name, blob in samples.items():
        cuts = list(range(0, min(120, len(blob)))) + list(
            np.linspace(120, len(blob) - 1, 30).astype(int))
        for i, cut in enumerate(cuts):
            (fdir / f"{name}_cut{i}").write_bytes(blob[:cut])
        for i in range(40):
            mutated = bytearray(blob)
            for _ in range(int(rng.integers(1, 8))):
                mutated[int(rng.integers(0, len(blob)))] = int(rng.integers(256))
            (fdir / f"{name}_mut{i}").write_bytes(bytes(mutated))

    def crafted_caf(fmt4, flags, bits, channels):
        desc = struct.pack(">d4sIIIII", 44100.0, fmt4, flags, 4, 1,
                           channels, bits)
        payload = struct.pack(">I", 0) + b"\x00" * 64
        return (b"caff\x00\x01\x00\x00"
                + b"desc" + struct.pack(">q", len(desc)) + desc
                + b"data" + struct.pack(">q", len(payload)) + payload)

    crafted = [
        (b"lpcm", 0, 16, 0), (b"lpcm", 0, 0, 1), (b"lpcm", 0, 4, 1),
        (b"lpcm", 1, 16, 1), (b"lpcm", 0, 24, 0xFFFFFFFF),
        (b"ulaw", 0, 8, 0), (b"alaw", 0, 8, 0),
    ]
    for i, args in enumerate(crafted):
        (fdir / f"caf_crafted{i}").write_bytes(crafted_caf(*args))
    return sorted(fdir.iterdir())


def main() -> int:
    if not binding.available():
        print("native decoder not built; nothing to check")
        return 1

    n_real = 0
    for f in corpus_files():
        samples, rate = binding.read_audio(str(f))
        assert samples.dtype == np.float32 and rate > 0, f
        samples2, _ = binding.read_caf(str(f))
        assert samples.shape == samples2.shape, f
        n_real += 1

    # Resampler: odd lengths + the production 160->1 style ratios.
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((4, 33)).astype(np.float32)
    for n in (1, 7, 63, 4001, 44100):
        x = rng.standard_normal(n).astype(np.float32)
        y = binding.resample(x, bank, 4, 25)
        assert y.dtype == np.float32

    with tempfile.TemporaryDirectory() as td:
        fuzz = build_fuzz_corpus(pathlib.Path(td))
        n_fuzz = decoded = 0
        for f in fuzz:
            n_fuzz += 1
            try:
                out, _ = binding.read_audio(str(f))
            except AudioDetectiveError:
                continue
            assert out.dtype == np.float32, f
            decoded += 1

    print(f"ASAN-NATIVE-OK real={n_real} fuzz={n_fuzz} decoded={decoded}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
