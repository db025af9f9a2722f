"""Host-side preprocessing of MiniCPM-o, the counterpart of
``x2i_tpu/data/minicpm_vision.py`` (numpy on the host, bit for bit the
JAX package's): the adaptive slicing at scale 448 (X2I takes one slice an
image), SigLIP's patches in (c, py, px) pixel order, NaViT's bucketized
position ids, the resampler's 2-D sincos slices, Whisper's log-mel
features in 30 s chunks, the audio placeholder arithmetic and the
conversion of placeholder spans into scatter maps. It also keeps the
port's own copies of three numpy tables that JAX keeps in its model
files: ``get_2d_sincos_pos_embed`` (``models/resampler.py``),
``chunk_bias`` and ``sinusoidal_positions`` (``models/whisper_enc.py``).

PIL is imported inside the functions that resize: the machine with the
card need not have it. There a request may give an image as the host
half's output instead, a pair (patches (n, 3 * 14^2) float32, (h, w)
patches), which ``prepare_minicpm_vision`` takes as one slice.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MEAN = np.array([0.5, 0.5, 0.5], np.float32)
STD = np.array([0.5, 0.5, 0.5], np.float32)


def _ensure_divide(length: int, patch_size: int) -> int:
    return max(round(length / patch_size) * patch_size, patch_size)


def find_best_resize(size: Tuple[int, int], scale_resolution: int = 448,
                     patch_size: int = 14,
                     allow_upscale: bool = False) -> Tuple[int, int]:
    w, h = size
    if w * h > scale_resolution * scale_resolution or allow_upscale:
        r = w / h
        h = int(scale_resolution / math.sqrt(r))
        w = int(h * r)
    return _ensure_divide(w, patch_size), _ensure_divide(h, patch_size)


def best_slice_grid(size: Tuple[int, int], max_slice_nums: int = 9,
                    scale_resolution: int = 448,
                    never_split: bool = False) -> Optional[Tuple[int, int]]:
    """The best (cols, rows) grid of slices, or None for no slicing."""
    w, h = size
    ratio = (w * h) / (scale_resolution * scale_resolution)
    multiple = min(math.ceil(ratio), max_slice_nums)
    if multiple <= 1 or never_split:
        return None
    candidates = {multiple, multiple - 1}
    if multiple < max_slice_nums:
        candidates.add(multiple + 1)
    candidates.discard(1)
    log_ratio = math.log(w / h)
    best, best_score = None, float("inf")
    for n in sorted(candidates):
        for m in range(1, n + 1):
            if n % m:
                continue
            score = abs(log_ratio - math.log(m / (n // m)))
            if score < best_score:
                best, best_score = (m, n // m), score
    return best


def normalize_image(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - MEAN) / STD


def patchify_siglip(image, patch_size: int = 14
                    ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL image -> (patches (gh * gw, 3 * ps^2) row-major, each in (c, py,
    px) order as SigLIP's conv kernel flattens, (gh, gw))."""
    arr = normalize_image(image)                      # (H, W, 3)
    h, w = arr.shape[:2]
    gh, gw = h // patch_size, w // patch_size
    x = arr[:gh * patch_size, :gw * patch_size].transpose(2, 0, 1)
    x = x.reshape(3, gh, patch_size, gw, patch_size)
    x = x.transpose(1, 3, 0, 2, 4)                    # (gh, gw, 3, ps, ps)
    return x.reshape(gh * gw, -1), (gh, gw)


def bucket_position_ids(tgt_size: Tuple[int, int],
                        num_patches_per_side: int = 70) -> np.ndarray:
    """NaViT's bucketized fractional position ids of a (gh, gw) grid."""
    gh, gw = tgt_size
    bounds = np.arange(1 / num_patches_per_side, 1.0,
                       1 / num_patches_per_side)
    bh = np.searchsorted(bounds, np.arange(0, 1 - 1e-6, 1 / gh),
                         side="right")
    bw = np.searchsorted(bounds, np.arange(0, 1 - 1e-6, 1 / gw),
                         side="right")
    return (bh[:, None] * num_patches_per_side + bw[None, :]).reshape(-1)


def slice_image(image, max_slice_nums: int = 9, scale_resolution: int = 448,
                patch_size: int = 14) -> List:
    """The source image resized, then the grid's slices; with
    ``max_slice_nums`` 1 or no grid, the resized image alone."""
    from PIL import Image
    grid = best_slice_grid(image.size, max_slice_nums, scale_resolution)
    if max_slice_nums == 1 or grid is None:
        w, h = find_best_resize(image.size, scale_resolution, patch_size,
                                allow_upscale=True)
        return [image.resize((w, h), Image.BICUBIC)]
    bw, bh = find_best_resize(image.size, scale_resolution, patch_size)
    out = [image.resize((bw, bh), Image.BICUBIC)]
    cols, rows = grid
    rw = _ensure_divide(int(image.size[0] / cols), patch_size)
    rh = _ensure_divide(int(image.size[1] / rows), patch_size)
    refined = image.resize((rw * cols, rh * rows), Image.BICUBIC)
    for r in range(rows):
        for c in range(cols):
            out.append(refined.crop((c * rw, r * rh, (c + 1) * rw,
                                     (r + 1) * rh)))
    return out


def get_2d_sincos_pos_embed(embed_dim: int, h: int, w: int) -> np.ndarray:
    """(h, w, embed_dim) sincos table of the resampler's keys. The first
    half of each embedding encodes the column (w), the second the row
    (h): the reference's meshgrid order, which matters on slices that are
    not square."""
    def one_axis(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float32) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("hw,d->hwd", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=-1)

    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32))
    return np.concatenate([one_axis(embed_dim // 2, grid_w),
                           one_axis(embed_dim // 2, grid_h)], axis=-1)


@functools.lru_cache(maxsize=4)
def _sincos_table(embed_dim: int, size: int) -> np.ndarray:
    """``get_2d_sincos_pos_embed`` of the whole size x size table, made
    once a process (70 x 70 x 3584 float32 at MiniCPM-o's sizes, which
    JAX's host half makes anew on every call), read-only."""
    table = get_2d_sincos_pos_embed(embed_dim, size, size)
    table.flags.writeable = False
    return table


def _slice_patches(image, patch_size, max_slice_nums, scale_resolution):
    """[(patches, (gh, gw))] of one request image: a host-half pair as it
    is, a PIL image sliced and patchified."""
    if isinstance(image, tuple):
        patches, (gh, gw) = image
        return [(np.asarray(patches, np.float32), (int(gh), int(gw)))]
    return [patchify_siglip(s, patch_size) for s in slice_image(
        image, max_slice_nums, scale_resolution=scale_resolution,
        patch_size=patch_size)]


def prepare_minicpm_vision(images: Sequence, llm_hidden: int,
                           max_slice_nums: int = 1, patch_size: int = 14,
                           num_patches_per_side: int = 70,
                           max_size: int = 70,
                           scale_resolution: int = 448) -> Optional[Dict]:
    """images -> the padded arrays of ``MiniCPMOEncoder.encode_images``:
    patches (N, L, 3 * ps^2), position_ids (N, L), patch_mask (N, L) and
    pos_embed (N, L, llm_hidden) over the N slices of all images, each
    padded to the longest (L patches); with tgt_sizes and num_slices.
    None without images."""
    packed = [p for im in images or [] for p in _slice_patches(
        im, patch_size, max_slice_nums, scale_resolution)]
    if not packed:
        return None
    max_len = max(p.shape[0] for p, _ in packed)
    n, patch_dim = len(packed), packed[0][0].shape[1]
    patches = np.zeros((n, max_len, patch_dim), np.float32)
    pos_ids = np.zeros((n, max_len), np.int32)
    mask = np.zeros((n, max_len), bool)
    pos_embed = np.zeros((n, max_len, llm_hidden), np.float32)
    table = _sincos_table(llm_hidden, max_size)
    for i, (p, (gh, gw)) in enumerate(packed):
        L = p.shape[0]
        patches[i, :L] = p
        pos_ids[i, :L] = bucket_position_ids((gh, gw), num_patches_per_side)
        mask[i, :L] = True
        pos_embed[i, :L] = table[:gh, :gw].reshape(gh * gw, -1)
    return {"patches": patches, "position_ids": pos_ids,
            "patch_mask": mask, "pos_embed": pos_embed,
            "tgt_sizes": [s for _, s in packed], "num_slices": n}


def bounds_to_map(bounds: Sequence[Sequence[Tuple[int, int]]],
                  seq_len: int,
                  rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Each row's [(start, end), ...] spans -> (B, S) int32: the flat
    feature row of each position inside a span, -1 elsewhere, the rows
    taken in span order over the batch. ``rows``: the feature rows to take
    instead of 0, 1, 2, ... (multi-chunk audio skips each chunk's pooled
    pad rows); raises ValueError when the spans do not use them all."""
    out = np.full((len(bounds), seq_len), -1, np.int32)
    row = 0
    for i, spans in enumerate(bounds):
        for st, ed in spans:
            n = ed - st
            out[i, st:ed] = (np.arange(row, row + n) if rows is None
                             else np.asarray(rows[row:row + n], np.int32))
            row += n
    if rows is not None and row != len(rows):
        raise ValueError(f"span total {row} != feature rows {len(rows)}")
    return out


# ---- Whisper's features (HF WhisperFeatureExtractor's arithmetic)

def mel_filterbank(sr: int = 16000, n_fft: int = 400,
                   n_mels: int = 80) -> np.ndarray:
    """Slaney-style mel filterbank (n_mels, n_fft // 2 + 1)."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float32)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10)
                                                   / 1000.0)
                        / np.log(6.4) * 27.0, 3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, np.float32)
        return np.where(m >= 15.0,
                        1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        200.0 * m / 3.0)

    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2),
                                   n_mels + 2))
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lower = (fft_freqs - hz_pts[i]) / max(hz_pts[i + 1] - hz_pts[i],
                                              1e-10)
        upper = (hz_pts[i + 2] - fft_freqs) / max(
            hz_pts[i + 2] - hz_pts[i + 1], 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return fb * enorm[:, None]


def log_mel_spectrogram(audio: np.ndarray, sr: int = 16000,
                        n_fft: int = 400, hop: int = 160,
                        n_mels: int = 80,
                        chunk_seconds: float = 30.0) -> np.ndarray:
    """A float waveform -> (n_mels, T) Whisper log-mel of one chunk, the
    waveform padded or cut to ``chunk_seconds``: a centred STFT with
    reflect padding and its last frame dropped, the log clipped 8 below
    its maximum, then (x + 4) / 4."""
    target = int(sr * chunk_seconds)
    audio = np.asarray(audio, np.float32)[:target]
    audio = np.pad(audio, (0, target - len(audio)))
    pad = n_fft // 2
    padded = np.pad(audio, (pad, pad), mode="reflect")
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    frames = 1 + len(audio) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
    stft = np.fft.rfft(padded[idx] * window, axis=-1)
    power = (np.abs(stft) ** 2)[:-1]                 # (T, n_fft/2+1)
    mel = mel_filterbank(sr, n_fft, n_mels) @ power.T
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def audio_placeholder_len(samples: int, sr: int = 16000, hop: int = 160,
                          pool_step: int = 2) -> int:
    """The LM tokens a clip of ``samples`` takes: its STFT frames, the
    stride-2 conv, then the average pool."""
    feature_lens = math.ceil(samples / hop)
    after_conv = (feature_lens - 1) // 2 + 1
    return (after_conv - pool_step) // pool_step + 1


def audio_placeholder_spans(samples: int, chunk_length: float = 1.0,
                            sr: int = 16000, hop: int = 160,
                            pool_step: int = 2) -> List[int]:
    """The placeholder spans of ``chunk_input``: the clip's tokens in runs
    of one ``chunk_length`` second each (25 tokens at 1 s), each wrapped
    in its own ``<audio>...</audio>`` pair."""
    output_lens = audio_placeholder_len(samples, sr, hop, pool_step)
    cnn_per_chunk = (int(chunk_length * 100) - 1) // 2 + 1
    per_chunk = (cnn_per_chunk - pool_step) // pool_step + 1
    spans, total = [], 0
    while total < output_lens:
        spans.append(min(per_chunk, output_lens - total))
        total += spans[-1]
    return spans


def chunk_audio_mels(audio: np.ndarray, sr: int = 16000,
                     n_fft: int = 400, hop: int = 160, n_mels: int = 80,
                     chunk_seconds: float = 30.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Audio longer than 30 s in consecutive 30 s chunks, each chunk's mel
    taken over its zero-padded 30 s window (the log's normalization sees
    the padding, as HF's extractor does), cut to its ceil(len / hop) valid
    frames and zero-padded to the longest chunk. -> (mels (A, n_mels,
    T_max) float32, lens (A,) int32 valid frames a chunk)."""
    audio = np.asarray(audio, np.float32)
    max_len = int(sr * chunk_seconds)
    n_chunks = max(1, math.ceil(len(audio) / max_len))
    chunks = [audio[i * max_len:(i + 1) * max_len] for i in range(n_chunks)]
    lens = np.array([math.ceil(len(c) / hop) for c in chunks], np.int32)
    mels = np.zeros((n_chunks, n_mels, int(lens.max())), np.float32)
    for i, (c, ln) in enumerate(zip(chunks, lens)):
        full = log_mel_spectrogram(c, sr, n_fft, hop, n_mels, chunk_seconds)
        mels[i, :, :ln] = full[:, :ln]
    return mels, lens


def chunk_bias(num_frames: int, chunk_frames: int,
               num_left_chunks: int = -1) -> np.ndarray:
    """Chunked attention's additive bias (1, 1, T, T), 0 or -1e30: frame i
    attends the frames of its chunk and of up to ``num_left_chunks``
    earlier chunks (-1: all)."""
    idx = np.arange(num_frames)
    chunk = idx // chunk_frames
    right = (chunk + 1) * chunk_frames                   # exclusive end
    left = (np.maximum(0, (chunk - num_left_chunks) * chunk_frames)
            if num_left_chunks >= 0 else np.zeros_like(idx))
    cols = idx[None, :]
    ok = (cols < right[:, None]) & (cols >= left[:, None])
    return np.where(ok, 0.0, -1e30).astype(np.float32)[None, None]


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper's fixed sinusoid table (length, dim): sines, then
    cosines."""
    log_timescale = math.log(10000) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2, dtype=np.float32))
    scaled = np.arange(length, dtype=np.float32)[:, None] * inv[None]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
