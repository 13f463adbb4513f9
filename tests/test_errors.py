"""Typed exception hierarchy (OSStatus-analogue semantics, SURVEY §5)."""

import numpy as np
import pytest

from lbaudiodetective import compat, errors
from lbaudiodetective.io.caf import read_caf
from lbaudiodetective.io.wav import read_wav


def test_hierarchy_and_status_codes():
    assert issubclass(errors.InvalidArgumentError, ValueError)
    assert issubclass(errors.DecodeError, ValueError)
    assert issubclass(errors.UnsupportedFormatError, NotImplementedError)
    assert issubclass(errors.UnsupportedFormatError, errors.DecodeError)
    assert errors.InvalidArgumentError.status == compat.kLBAudioDetectiveArgumentInvalid
    assert errors.DecodeError.status != errors.UnsupportedFormatError.status


def test_invalid_argument_raises_typed():
    with pytest.raises(errors.InvalidArgumentError):
        compat.LBAudioDetectiveDispose(None)
    d = compat.LBAudioDetectiveNew()
    with pytest.raises(errors.InvalidArgumentError):
        compat.LBAudioDetectiveProcessAudioURL(d, None)


def test_decode_errors_typed(tmp_path):
    bad = tmp_path / "bad.caf"
    bad.write_bytes(b"not a caf at all" * 4)
    with pytest.raises(errors.DecodeError):
        read_caf(str(bad))
    badw = tmp_path / "bad.wav"
    badw.write_bytes(b"RIFFxxxxNOPE" + b"\0" * 64)
    with pytest.raises(errors.DecodeError):
        read_wav(str(badw))
