"""The seeded bird-call generator: deterministic, and round-tripping through
the repo's WAV, AIFF and AU writers and decoders."""

import numpy as np
import pytest

from lbaudiodetective.io.aiff import write_aiff
from lbaudiodetective.io.au import write_au
from lbaudiodetective.io.decode import decode_audio_file
from lbaudiodetective.io.resample import resample_rational
from lbaudiodetective.io.wav import write_wav
from lbaudiodetective.utils.synth import bird_calls


def test_deterministic_and_distinct():
    a = bird_calls(7, 3, seconds=1.0)
    b = bird_calls(7, 3, seconds=1.0)
    assert a.shape == (3, 44100) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, bird_calls(8, 3, seconds=1.0))
    assert not np.array_equal(a[0], a[1])
    assert np.abs(a).max() < 1.0 and a.std() > 0.01


@pytest.mark.parametrize("write,ext", [(write_wav, "wav"), (write_aiff, "aiff"),
                                       (write_au, "au")])
def test_round_trip_through_writers(tmp_path, write, ext):
    x = bird_calls(3, 1, seconds=1.5)[0]
    path = str(tmp_path / f"clip.{ext}")
    write(path, x, 44100.0)
    d = decode_audio_file(path)
    assert d.file_rate == 44100.0 and d.file_frames == len(x)
    # 16-bit PCM quantisation, then the shared resampler.
    pcm = (np.round(x * 32767.0) / 32768.0).astype(np.float32)
    want = resample_rational(pcm, 44100.0, 5512.0)
    np.testing.assert_allclose(d.samples, want, atol=1e-5)
