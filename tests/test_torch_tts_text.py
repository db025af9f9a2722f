"""The port's copy of the TTS text normalisation and audio checks
(x2i_torch/data/tts_text.py) against the JAX package's
(x2i_tpu/data/tts_text.py): the same answers on the same strings and
numpy arrays, exactly."""

import numpy as np
import pytest

from x2i_torch.data import tts_text as tt
from x2i_tpu.data import tts_text as jt

TEXTS = ["call me at 42 past 7", "它有3条腿和12只眼睛", "pi is 3.14!",
         "no digits here", "", "mixed 中文 and 2024 english 9",
         "Version 2.0. Done? Yes！", "数字0与100。", "a.b.c", "ends with 5."]


@pytest.mark.parametrize("text", TEXTS)
def test_text_functions_match_jax(text):
    assert tt.detect_language(text) == jt.detect_language(text)
    assert tt.sentence_end(text) == jt.sentence_end(text)
    assert (tt.replace_numbers_with_text(text)
            == jt.replace_numbers_with_text(text))
    for lang in ("chinese", "english"):
        assert (tt.replace_numbers_with_text(text, lang)
                == jt.replace_numbers_with_text(text, lang))
        assert tt.spell_digits("90210", lang) == jt.spell_digits("90210",
                                                                 lang)


def test_array_functions_match_jax():
    rng = np.random.default_rng(0)
    for scale in (1e-4, 2e-3, 0.5):
        wav = (scale * rng.standard_normal(4000)).astype(np.float32)
        assert tt.is_silent(wav) == jt.is_silent(wav)
    spec = np.abs(rng.standard_normal((20, 30))) ** 4
    spec[0, :5] = 0.0
    for top_db in (80.0, 20.0):
        np.testing.assert_array_equal(tt.power_to_db(spec, top_db=top_db),
                                      jt.power_to_db(spec, top_db=top_db))


def _chunks(rng, kind):
    """A waveform of 12 chunks of 2560 samples and its (80, 48) mel:
    silent, stagnant (each mel chunk within 0.1% of the last) or lively
    (the mel's level jumps by 90 dB from chunk to chunk)."""
    n = 12 * 2560
    if kind == "silent":
        wav = np.zeros(n, np.float32)
    else:
        wav = (0.3 * rng.standard_normal(n)).astype(np.float32)
    mel = np.tile(np.abs(rng.standard_normal((80, 4))) + 0.1, (1, 12))
    if kind == "lively":
        return wav, mel * np.where(np.arange(48) // 4 % 2, 1e6, 1e-3)
    return wav, mel * (1 + 1e-3 * rng.standard_normal((80, 48)))


@pytest.mark.parametrize("kind", ["silent", "stagnant", "lively"])
def test_voice_checker_matches_jax(kind):
    """The same verdict and the same running state after each call, over
    two calls (the checker keeps the previous mel between them)."""
    ours, theirs = tt.VoiceChecker(), jt.VoiceChecker()
    rng = np.random.default_rng(1)
    for _ in range(2):
        wav, mel = _chunks(rng, kind)
        assert ours.is_bad(wav, mel) == theirs.is_bad(wav, mel)
        assert (ours.consecutive_zeros, ours.consecutive_low_distance) == (
            theirs.consecutive_zeros, theirs.consecutive_low_distance)
        np.testing.assert_array_equal(ours.previous_mel, theirs.previous_mel)
    ours.reset()
    assert ours.previous_mel is None and ours.consecutive_zeros == 0
