"""TTS-side text normalisation and audio-quality checking, the port's
copy of ``x2i_tpu/data/tts_text.py`` (the reference's ``minicpm/utils.py``
behaviour): digit-by-digit number spelling, so that the TTS GPT never
reads numerals (the streaming speech path applies it), sentence-end
detection for chunking, and a mel-distance silence and stagnation
detector for generated audio. numpy only (``power_to_db`` is librosa's,
inlined).
"""

from __future__ import annotations

import logging
import re
from typing import Optional

import numpy as np

log = logging.getLogger("x2i_torch")

_DIGITS_ZH = "零一二三四五六七八九"
_DIGITS_EN = ("zero", "one", "two", "three", "four",
              "five", "six", "seven", "eight", "nine")

_SENTENCE_ENDS = [".", "。", "!", "?", "！", "？"]


def is_silent(wav: np.ndarray, thresh: float = 3e-3) -> bool:
    """True if the chunk's peak amplitude is below thresh (utils.py:25)."""
    return bool(np.abs(wav).max() < thresh)


def sentence_end(text: str) -> str:
    """First sentence-ending punctuation in text, skipping '.' directly
    after a digit (decimal points, utils.py:32-41). Returns '' if none."""
    for c in _SENTENCE_ENDS:
        idx = text.find(c)
        if idx < 0:
            continue
        if c == "." and idx > 0 and text[idx - 1].isdigit():
            continue
        return c
    return ""


def detect_language(text: str) -> str:
    """'chinese' when CJK chars >= latin letters, else 'english'."""
    zh = len(re.findall(r"[一-鿿]", text))
    en = len(re.findall(r"[a-zA-Z]", text))
    return "chinese" if zh >= en else "english"


def spell_digits(num: str, language: str) -> str:
    """Digit-by-digit spelling: '23' -> 'two three' / '二三'."""
    if language == "chinese":
        return "".join(_DIGITS_ZH[int(c)] for c in num if c.isdigit())
    return " ".join(_DIGITS_EN[int(c)] for c in num if c.isdigit())


def replace_numbers_with_text(text: str,
                              language: Optional[str] = None) -> str:
    """Replace every numeric run with its spelled-out form (the reference
    applies this before streaming TTS so numbers are read reliably,
    utils.py:111-123)."""
    if language is None:
        language = detect_language(text)
    return re.sub(r"\d+", lambda m: spell_digits(m.group(), language),
                  text)


def power_to_db(spec: np.ndarray, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db with ref=1.0."""
    db = 10.0 * np.log10(np.maximum(amin, spec))
    return np.maximum(db, db.max() - top_db)


class VoiceChecker:
    """Flags generated audio as bad when it is persistently silent
    (>= 12 consecutive silent chunks = 1.2 s at chunk_size 2560 / 16 kHz)
    or stagnant (>= 5 consecutive chunks whose mean-mel l2 distance to the
    previous chunk is below thresh) — utils.py:126-203."""

    def __init__(self):
        self.previous_mel: Optional[np.ndarray] = None
        self.consecutive_zeros = 0
        self.consecutive_low_distance = 0

    def reset(self) -> None:
        self.previous_mel = None
        self.consecutive_zeros = 0
        self.consecutive_low_distance = 0

    def compute_distance(self, wav_chunk: np.ndarray,
                         mel_chunk: np.ndarray) -> float:
        if is_silent(wav_chunk):
            return 0.0
        mel_db = power_to_db(mel_chunk)
        if self.previous_mel is None:
            self.previous_mel = mel_db
            return -1.0
        dist = float(np.linalg.norm(mel_db.mean(axis=1)
                                    - self.previous_mel.mean(axis=1)))
        self.previous_mel = mel_db
        return dist

    def is_bad(self, wav: np.ndarray, mel_spec: np.ndarray,
               chunk_size: int = 2560, thresh: float = 100.0) -> bool:
        num_chunks = len(wav) // chunk_size
        if num_chunks == 0:
            return False
        mel_chunk = mel_spec.shape[-1] // num_chunks
        for i in range(num_chunks):
            dist = self.compute_distance(
                wav[i * chunk_size:(i + 1) * chunk_size],
                mel_spec[:, i * mel_chunk:(i + 1) * mel_chunk])
            if dist == 0:
                self.consecutive_low_distance = 0
                self.consecutive_zeros += 1
                if self.consecutive_zeros >= 12:
                    log.warning("VoiceChecker: 1.2 s of silence")
                    return True
            elif dist < thresh:
                self.consecutive_zeros = 0
                self.consecutive_low_distance += 1
                if self.consecutive_low_distance >= 5:
                    log.warning("VoiceChecker: 5 stagnant chunks")
                    return True
            else:
                self.consecutive_zeros = 0
                self.consecutive_low_distance = 0
        return False
