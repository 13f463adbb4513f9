"""Test harness configuration.

All tests run on the CPU backend with 8 virtual devices
(xla_force_host_platform_device_count) — the standard JAX way to exercise
pjit/shard_map/collectives without a pod (SURVEY.md §4).  These env vars must
be set before `import jax`, hence this file sets them at import time.

Corpus decode + oracle fingerprints are disk-cached under tests/_cache so
repeated runs are fast.
"""

import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
existing_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in existing_flags:
    os.environ["XLA_FLAGS"] = (
        existing_flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already have been imported (and read its environment) before this
# file ran, so force the platform through the live config object as well.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

CORPUS = pathlib.Path("/root/reference/LBAudioDetectiveTests/Birds")
CACHE = REPO_ROOT / "tests" / "_cache"
CACHE.mkdir(exist_ok=True)

# Persistent XLA compilation cache: repeated test runs skip recompilation.
# The dir is keyed by a host-CPU-feature fingerprint: XLA's cache key does
# NOT include machine features, and loading a CPU AOT executable compiled on
# a host with different features (these VMs migrate between machine types
# across sessions) segfaults inside cpu_aot_loader.  A new machine type gets
# a cold cache instead of a crash.


def _host_cpu_tag() -> str:
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:10]
    except OSError:
        pass
    return "unknown"


if not os.environ.get("LBAD_NO_XLA_CACHE"):
    jax.config.update("jax_compilation_cache_dir",
                      str(CACHE / f"xla_cpu_{_host_cpu_tag()}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

BIRDS = ["BlackBird", "BlueTit", "Chaffinch", "Sparrow", "GreatTit",
         "Crow", "Wren", "Chiffchaff", "Kestrel", "Pigeon"]
SUFFIX_DIRS = {"_eql": "Cropped/Equal", "_dif": "Cropped/Different",
               "_blu1": "Cropped/Blurred", "_blu2": "Cropped/Blurred",
               "_rec": "Cropped/Recorded"}


def corpus_path(name: str) -> str:
    """Resolve a corpus clip name like 'BlackBird' or 'Wren_blu1' to a path."""
    for suffix, sub in SUFFIX_DIRS.items():
        if name.endswith(suffix):
            return str(CORPUS / sub / f"{name}.caf")
    return str(CORPUS / "Archive" / f"{name}.caf")


class _LazyDict:
    """Dict-like that computes and disk-caches entries on first access."""

    def __init__(self, loader):
        self._loader = loader
        self._data = {}

    def __getitem__(self, name):
        if name not in self._data:
            self._data[name] = self._loader(name)
        return self._data[name]

    def keys(self):
        names = list(BIRDS)
        for suffix in SUFFIX_DIRS:
            names += [b + suffix for b in BIRDS]
        return names

    def items(self):
        return ((n, self[n]) for n in self.keys())


def _io_code_hash() -> str:
    """Hash of the decode/resample sources (keys the decoded_* cache)."""
    import hashlib

    io_dir = REPO_ROOT / "lbaudiodetective" / "io"
    h = hashlib.sha256()
    for f in sorted(list(io_dir.glob("*.py")) + list(io_dir.glob("native/*.cpp"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:8]


@pytest.fixture(scope="session")
def decoded_corpus():
    """name -> DecodedAudio, computed lazily and disk-cached."""
    from lbaudiodetective.io.decode import DecodedAudio, decode_audio_file

    io_key = _io_code_hash()

    def load(name):
        cache_file = CACHE / f"decoded_{io_key}_{name}.npz"
        if cache_file.exists():
            z = np.load(cache_file)
            return DecodedAudio(samples=z["samples"],
                                processing_rate=float(z["processing_rate"]),
                                file_frames=int(z["file_frames"]),
                                file_rate=float(z["file_rate"]))
        d = decode_audio_file(corpus_path(name))
        np.savez(cache_file, samples=d.samples, processing_rate=d.processing_rate,
                 file_frames=d.file_frames, file_rate=d.file_rate)
        return d

    return _LazyDict(load)


def canary_digest() -> str:
    """Digest of the fingerprints the live CPU pipeline extracts from two
    seeded synthetic clips at the default config.

    Keying the committed corpus fixtures on behaviour (not source text)
    lets refactors that leave every fingerprint bit unchanged keep the
    fixtures, while any change to the extracted bits re-keys them: the
    corpus tests then recompute live and fail loudly instead of staying
    silently green against stale fixtures.
    """
    import hashlib

    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.ops.extract import extract_fingerprint

    cfg = FingerprintConfig()
    rng = np.random.default_rng(20261016)
    h = hashlib.sha256()
    for _ in range(2):
        n = int(3.0 * cfg.processing_sample_rate)
        t = np.arange(n) / cfg.processing_sample_rate
        f0 = rng.uniform(600.0, 1400.0)
        x = (0.3 * np.sin(2 * np.pi * (f0 * t + 150.0 * t ** 2))
             + 0.02 * np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        audio = DecodedAudio(x, cfg.processing_sample_rate,
                             int(3.0 * cfg.file_sample_rate),
                             cfg.file_sample_rate)
        pos, neg, _ = extract_fingerprint(audio, cfg)
        h.update(np.ascontiguousarray(pos).tobytes())
        h.update(np.ascontiguousarray(neg).tobytes())
    return h.hexdigest()[:8]


def _prune_stale_fixture_caches(key: str) -> None:
    """Delete fixture files whose key is no longer current, so superseded
    ``jaxfp_*``/``oracle_*`` generations do not accumulate on disk or in
    git (a normal ``git add -A`` records the removals).  decoded_* files
    key on the io-code hash of :func:`decoded_corpus`."""
    for prefix in ("jaxfp", "oracle"):
        for f in CACHE.glob(f"{prefix}_*.npz"):
            if not f.name.startswith(f"{prefix}_{key}_"):
                f.unlink(missing_ok=True)
    io_key = _io_code_hash()
    for f in CACHE.glob("decoded_*.npz"):
        if not f.name.startswith(f"decoded_{io_key}_"):
            f.unlink(missing_ok=True)


@pytest.fixture(scope="session")
def fixture_key() -> str:
    """Cache key of the committed corpus fixtures: config-params hash +
    :func:`canary_digest`.  Computed lazily (first test that needs it), and
    prunes stale fixture generations."""
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.utils.serialize import config_params_hash

    key = f"{config_params_hash(FingerprintConfig())[:8]}-{canary_digest()}"
    _prune_stale_fixture_caches(key)
    return key


@pytest.fixture(scope="session")
def oracle_fingerprints(decoded_corpus, fixture_key):
    """name -> (pos, neg) golden-oracle fingerprints, lazy + disk-cached."""
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.oracle.pipeline import oracle_fingerprint

    cfg = FingerprintConfig()
    key = fixture_key

    def load(name):
        cache_file = CACHE / f"oracle_{key}_{name}.npz"
        if cache_file.exists():
            z = np.load(cache_file)
            return (z["pos"], z["neg"])
        pos, neg = oracle_fingerprint(decoded_corpus[name], cfg)
        np.savez(cache_file, pos=pos, neg=neg)
        return (pos, neg)

    return _LazyDict(load)


@pytest.fixture(scope="session")
def default_config():
    from lbaudiodetective.config import FingerprintConfig

    return FingerprintConfig()
