"""The port's WAV / AIFF writer and reader against the JAX package's
``utils.audio``: the same samples give the same bytes at every bit depth,
each package reads the other's files to the same arrays, and a round trip
returns the samples to the format's quantisation."""

import numpy as np
import pytest
import torch

from wayverb_tpu.utils import audio as jau
from wayverb_tpu_torch.utils import audio as tau

WAV_DEPTHS = {"pcm16": 1 / 32767, "pcm24": 1 / 8388607, "float32": 1e-7}
AIFF_DEPTHS = {"pcm16": 1 / 32767, "pcm24": 1 / 8388607}


def _signal(rng, channels):
    x = rng.uniform(-1.0, 1.0, size=(channels, 1001))
    x[0, :3] = (1.0, -1.0, 0.0)     # the full scale and silence
    return x if channels > 1 else x[0]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("depth", sorted(WAV_DEPTHS))
def test_wav_bytes_match_and_round_trip(rng, tmp_path, depth, channels):
    x = _signal(rng, channels)
    mine, ref = str(tmp_path / "port.wav"), str(tmp_path / "ref.wav")
    tau.write_wav(mine, torch.from_numpy(x), 44100.0, bit_depth=depth)
    jau.write_wav(ref, x, 44100.0, bit_depth=depth)
    assert _bytes(mine) == _bytes(ref)
    got, rate = tau.read_wav(ref)
    want, jrate = jau.read_wav(mine)
    assert rate == jrate == 44100.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.atleast_2d(x), rtol=0,
                               atol=WAV_DEPTHS[depth])


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("depth", sorted(AIFF_DEPTHS))
def test_aiff_bytes_match_and_round_trip(rng, tmp_path, depth, channels):
    x = _signal(rng, channels)
    mine, ref = str(tmp_path / "port.aiff"), str(tmp_path / "ref.aiff")
    tau.write_aiff(mine, x, 48000.0, bit_depth=depth)
    jau.write_aiff(ref, x, 48000.0, bit_depth=depth)
    assert _bytes(mine) == _bytes(ref)
    got, rate = tau.read_aiff(ref)
    want, jrate = jau.read_aiff(mine)
    assert rate == jrate == 48000.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.atleast_2d(x), rtol=0,
                               atol=AIFF_DEPTHS[depth])


def test_write_audio_dispatches_on_extension(rng, tmp_path):
    x = _signal(rng, 1)
    for name, reader in (("a.wav", tau.read_wav), ("a.aif", tau.read_aiff),
                         ("a.AIFF", tau.read_aiff)):
        mine, ref = str(tmp_path / f"p_{name}"), str(tmp_path / f"r_{name}")
        tau.write_audio(mine, x, 22050.0)
        jau.write_audio(ref, x, 22050.0)
        assert _bytes(mine) == _bytes(ref)
        assert reader(mine)[1] == 22050.0
    with pytest.raises(ValueError):
        tau.write_wav(str(tmp_path / "bad.wav"), x, 8000.0, bit_depth="pcm8")
    with pytest.raises(ValueError):
        tau.read_wav(str(tmp_path / "p_a.aif"))
