"""Evaluation metrics, the counterpart of ``x2i_tpu/evalmetrics.py``: the
CLIP-T score and the seed-matched comparison protocol of BASELINE.md
(fixed prompts and seeds; bitwise latents across RNGs are impossible),
and the Fréchet distance over image features ("CLIP-FID" with CLIP's).

  * ``preprocess_clip_images``: the host half, uint8 images -> CLIP-
    normalized 224^2 pixels (PIL's bicubic resize, JAX's expressions in
    JAX's order; PIL is imported inside it);
  * ``CLIPScorer``: both towers, the projections into the shared space,
    and ``clip_t`` = 100 x cosine(image, text). ``image_features`` takes
    uint8 images or the host half's output, float (B, size, size, 3)
    pixels: where PIL is missing, as on the card's machine, the caller
    resizes;
  * ``build_clip_scorer``: an HF CLIPModel directory -> a scorer, in f32
    by default as in JAX, on the card unless the caller names another
    device;
  * ``frechet_distance`` (numpy, JAX's bit for bit) and
    ``seed_matched_protocol``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from x2i_torch.convert.load import load_clip, load_tokenizer
from x2i_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_clip_images(images: np.ndarray,
                           size: int = 224) -> np.ndarray:
    """uint8 (B, H, W, 3) -> CLIP-normalized (B, size, size, 3) f32."""
    from PIL import Image
    out = []
    for img in images:
        pil = Image.fromarray(np.asarray(img, np.uint8)).resize(
            (size, size), Image.BICUBIC)
        out.append((np.asarray(pil, np.float32) / 255.0 - CLIP_MEAN)
                   / CLIP_STD)
    return np.stack(out)


def _normalized(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)


@dataclasses.dataclass
class CLIPScorer:
    """The full CLIP scoring head. The projections map both towers'
    pooled outputs to the shared space; score = 100 * cosine(image, text)
    (the standard CLIP-T). Features are f32 unit vectors on the towers'
    device."""

    text_model: CLIPTextEncoder
    vision_model: CLIPVisionEncoder
    text_projection: torch.Tensor        # (text_hidden, proj)
    visual_projection: torch.Tensor      # (vision_hidden, proj)
    tokenize: Callable[[str], np.ndarray]
    load_report: Optional[dict] = None

    @torch.no_grad()
    def text_features(self, texts: Sequence[str]) -> torch.Tensor:
        dev = self.text_projection.device
        ids = np.stack([self.tokenize(t) for t in texts])
        _, pooled = self.text_model(torch.as_tensor(ids, device=dev))
        return _normalized(pooled.float() @ self.text_projection.float())

    @torch.no_grad()
    def image_features(self, images) -> torch.Tensor:
        """images: uint8 (B, H, W, 3), resized here by
        ``preprocess_clip_images``, or the host half's float (B, size,
        size, 3) CLIP-normalized pixels (numpy or a tensor)."""
        dev = self.visual_projection.device
        if not torch.is_tensor(images) and np.asarray(images).dtype == \
                np.uint8:
            images = preprocess_clip_images(
                images, self.vision_model.cfg.image_size)
        _, pooled = self.vision_model(torch.as_tensor(images, device=dev))
        return _normalized(pooled.float() @ self.visual_projection.float())

    def clip_t(self, images, texts: Sequence[str]) -> np.ndarray:
        """Per-pair CLIP-T scores (B,)."""
        img = self.image_features(images)
        txt = self.text_features(texts)
        return (100.0 * (img * txt).sum(-1)).cpu().numpy()


def scorer_from_model(model, tokenize: Callable[[str], np.ndarray]
                      ) -> CLIPScorer:
    """A scorer over a ``models.clip.CLIPModel`` (its projections as
    (hidden, proj) matrices)."""
    return CLIPScorer(
        text_model=model.text_model, vision_model=model.vision_model,
        text_projection=model.text_projection.weight.detach().T,
        visual_projection=model.visual_projection.weight.detach().T,
        tokenize=tokenize)


def build_clip_scorer(clip_path: str, dtype=torch.float32, device=None,
                      tokenizer=None) -> CLIPScorer:
    """One-call loader: an HF CLIP checkpoint directory (config.json and
    safetensors or pytorch_model.bin of a ``transformers.CLIPModel``, e.g.
    openai/clip-vit-large-patch14) -> ``CLIPScorer`` with both towers and
    the projections, through ``convert/load.py::load_clip``. The
    tokenize callable pads and cuts to the text tower's
    ``max_position_embeddings``; ``tokenizer``: an HF-style tokenizer,
    None loads the directory's ``CLIPTokenizerFast``. f32 by default for
    score stability, as JAX."""
    model, report = load_clip(clip_path, device, dtype)
    tok = tokenizer or load_tokenizer(clip_path, "CLIPTokenizerFast")
    max_len = model.text_model.cfg.max_position_embeddings

    def tokenize(text: str) -> np.ndarray:
        return np.asarray(
            tok(text, padding="max_length", truncation=True,
                max_length=max_len)["input_ids"], np.int32)

    return dataclasses.replace(scorer_from_model(model, tokenize),
                               load_report=report)


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """scipy-free Fréchet distance (FID with inception-style features;
    CLIP features here => 'CLIP-FID'): trace term via eigenvalues of
    cov_a @ cov_b (trace sqrtm(A B) == sum sqrt eig(A B))."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    diff = float(((mu_a - mu_b) ** 2).sum())
    eig = np.linalg.eigvals(cov_a @ cov_b)
    tr_sqrt = float(np.sqrt(np.maximum(eig.real, 0.0)).sum())
    return diff + float(np.trace(cov_a) + np.trace(cov_b)) - 2.0 * tr_sqrt


def seed_matched_protocol(generate: Callable[[str, int], np.ndarray],
                          prompts: Sequence[str],
                          seeds: Sequence[int]) -> np.ndarray:
    """The BASELINE seed-matched generation grid: one image per (prompt,
    seed), prompt-major; -> (len(prompts) * len(seeds), H, W, 3) uint8."""
    out = []
    for prompt in prompts:
        for seed in seeds:
            out.append(generate(prompt, seed)[0])
    return np.stack(out)
