"""Bit packing + on-disk serialization tests."""

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.utils import packing, serialize


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(12)
    plane = rng.integers(0, 2, size=(7, 100)).astype(np.uint8)
    words = packing.pack_bits(plane)
    assert words.shape == (7, 4)
    np.testing.assert_array_equal(packing.unpack_bits(words, 100), plane)


def test_pack_bit_order():
    plane = np.zeros((1, 100), np.uint8)
    plane[0, 0] = 1   # bit 0 of word 0
    plane[0, 33] = 1  # bit 1 of word 1
    words = packing.pack_bits(plane)
    assert words[0, 0] == 1
    assert words[0, 1] == 2


def test_fingerprint_packed_roundtrip():
    rng = np.random.default_rng(13)
    cls = rng.choice(3, size=(5, 100))
    fp = Fingerprint.from_planes((cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8))
    pw, nw = fp.packed()
    fp2 = Fingerprint.from_packed(pw, nw, 100)
    assert fp == fp2


def test_save_load_fingerprint(tmp_path):
    cfg = FingerprintConfig()
    rng = np.random.default_rng(14)
    cls = rng.choice(3, size=(6, 100))
    fp = Fingerprint.from_planes((cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8))
    path = str(tmp_path / "fp.npz")
    serialize.save_fingerprint(path, fp, cfg)
    loaded = serialize.load_fingerprint(path, cfg)
    assert loaded == fp
    # A different config refuses to load (parameter hash mismatch).
    other = cfg.with_updates(analysis_stride=32)
    with pytest.raises(ValueError):
        serialize.load_fingerprint(path, other)


def test_sharded_library_roundtrip_and_resume(tmp_path):
    """SURVEY §5 checkpoint/resume: shards are mmap-able and shard-local
    reload reproduces every entry (the restart path of a slice-local
    matcher)."""
    cfg = FingerprintConfig()
    rng = np.random.default_rng(16)
    fps = []
    for n in (3, 7, 5, 4, 6):
        cls = rng.choice(3, size=(n, 100))
        fps.append(Fingerprint.from_planes((cls == 1).astype(np.uint8),
                                           (cls == 2).astype(np.uint8)))
    d = str(tmp_path / "libdb")
    serialize.save_library_sharded(d, fps, cfg, n_shards=2)

    seen = []
    for s in range(2):
        pos, neg, counts, man = serialize.load_library_shard(d, s, cfg)
        assert isinstance(pos, np.memmap)          # actually memory-mapped
        assert pos.shape == (man["entries_per_shard"], man["s_max"],
                             man["words"])
        for i in range(pos.shape[0]):
            if counts[i] == 0:
                continue
            seen.append(Fingerprint.from_packed(
                np.asarray(pos[i, :counts[i]]), np.asarray(neg[i, :counts[i]]),
                man["pairs"]))
    assert seen == fps

    with pytest.raises(ValueError):
        serialize.load_library_shard(d, 0, cfg.with_updates(analysis_stride=32))
    with pytest.raises(ValueError):
        serialize.load_library_shard(d, 9, cfg)


def test_save_load_library(tmp_path):
    cfg = FingerprintConfig()
    rng = np.random.default_rng(15)
    fps = []
    for n in (3, 7, 5):
        cls = rng.choice(3, size=(n, 100))
        fps.append(Fingerprint.from_planes((cls == 1).astype(np.uint8),
                                           (cls == 2).astype(np.uint8)))
    path = str(tmp_path / "lib.npz")
    serialize.save_library(path, fps, cfg)
    pos, neg, counts, pairs = serialize.load_library(path, cfg)
    assert pos.shape == (3, 7, 4) and pairs == 100
    np.testing.assert_array_equal(counts, [3, 7, 5])
    for i, fp in enumerate(fps):
        got = Fingerprint.from_packed(pos[i, :counts[i]], neg[i, :counts[i]], pairs)
        assert got == fp
