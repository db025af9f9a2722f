"""Datamodules: tar-shard sample -> training batch, the counterpart of
``x2i_tpu/data/datamodule.py`` (host code, numpy: on the same shards with
the same tokenize callables and seed, every batch is JAX's bit for bit).

Phase 1 (``DistillDataModule``): each sample carries a json with
``caption_en``; the caption is wrapped in the canonical instruction dict
{"Text input": cap, "Instruction editing description": "no", "image
input": "no"}, chat-templated and tokenized for the MLLM (512 tokens), with
raw-caption T5 (512) and CLIP (77) teacher ids. Phase 2
(``LightControlDataModule``): editing pairs and self-reconstruction
samples with their images. Tokenizers are injected (host-side callables);
``synthetic_distill_batches`` gives the phase-1 schema without assets.

``train_loader(device_put=None)`` runs JAX's stages in JAX's order
(ShardSampler -> tar_samples -> decode -> verify -> preproc -> batch)
behind a ``PrefetchLoader``; pass ``loader.StreamCopy(device)`` to get
batches on the device.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from x2i_torch.data.loader import PrefetchLoader, stack_collate
from x2i_torch.data.webdataset import Pipeline, ShardSampler, tar_samples


def instruction_dict(caption: str, edit: str = "no",
                     image_input: str = "no") -> str:
    """The canonical X2I instruction wrapper (inference uses the same
    dict)."""
    return str({"Text input": caption, "Instruction editing description":
                edit, "image input": image_input})


def family_chat_template(model: str, mllm_tokenizer) -> Callable[[str], str]:
    """The training-time prompt wrapper of each encoder family, as the
    reference datamodules have it: InternVL tokenizes the plain
    str(Instructions) (its template call is commented out in the
    reference); MiniCPM chat-templates a plain-string user message; Qwen
    chat-templates a typed content list (some templates render a list
    and a string differently). ``mllm_tokenizer`` carries
    ``apply_chat_template``."""
    if "internvl" in model:
        return lambda s: s
    if "qwenvl" in model:
        return lambda s: mllm_tokenizer.apply_chat_template(
            [{"role": "user",
              "content": [{"type": "text", "text": s}]}],
            tokenize=False, add_generation_prompt=True)
    return lambda s: mllm_tokenizer.apply_chat_template(
        [{"role": "user", "content": s}], tokenize=False,
        add_generation_prompt=True)


def hf_tokenize(tokenizer, max_length: int, with_mask: bool = True):
    """text -> (ids, mask), or the ids alone: an HF-style tokenizer's ids
    padded and cut to ``max_length`` (the reference datamodules' call)."""
    def tokenize(text):
        out = tokenizer(text, padding="max_length", max_length=max_length,
                        truncation=True)
        if with_mask:
            return out["input_ids"], out["attention_mask"]
        return out["input_ids"]
    return tokenize


@dataclasses.dataclass
class DistillDataConfig:
    urls: Any = None
    batch_size: int = 1
    text_seq_len: int = 512
    clip_seq_len: int = 77
    seed: int = 0
    num_workers: int = 0


class DistillDataModule:
    """Produces batches {"mllm_ids", "mllm_mask", "t5_ids", "t5_mask",
    "clip_ids"} (numpy) for ``train/distill.py``.

    Args:
      mllm_tokenize: fn(chat prompt) -> (ids, mask), both (S,).
      t5_tokenize: fn(caption) -> (ids, mask).
      clip_tokenize: fn(caption) -> ids.
      chat_template: fn(instruction str) -> prompt string.
    """

    def __init__(self, cfg: DistillDataConfig,
                 mllm_tokenize: Callable,
                 t5_tokenize: Callable,
                 clip_tokenize: Callable,
                 chat_template: Callable[[str], str] = lambda s: s):
        self.cfg = cfg
        self.mllm_tokenize = mllm_tokenize
        self.t5_tokenize = t5_tokenize
        self.clip_tokenize = clip_tokenize
        self.chat_template = chat_template

    def preproc(self, sample: Dict) -> Dict:
        caption = sample["json"]["caption_en"]
        prompt = self.chat_template(instruction_dict(caption))
        mllm_ids, mllm_mask = self.mllm_tokenize(prompt)
        t5_ids, t5_mask = self.t5_tokenize(caption)
        clip_ids = self.clip_tokenize(caption)
        return {
            "mllm_ids": np.asarray(mllm_ids, np.int32),
            "mllm_mask": np.asarray(mllm_mask, bool),
            "t5_ids": np.asarray(t5_ids, np.int32),
            "t5_mask": np.asarray(t5_mask, bool),
            "clip_ids": np.asarray(clip_ids, np.int32),
        }

    def train_loader(self, device_put: Optional[Callable] = None,
                     timeout: float = 600.0) -> PrefetchLoader:
        """The batches through a ``PrefetchLoader`` (``timeout``: the
        longest wait for one batch)."""
        shards = ShardSampler(self.cfg.urls, seed=self.cfg.seed)
        pipe = (Pipeline(tar_samples(iter(shards)))
                .decode()
                .verify(["json"])
                .map(self.preproc)
                .batch(self.cfg.batch_size, stack_collate))
        return PrefetchLoader(pipe, device_put=device_put, timeout=timeout)


class LightControlDataModule:
    """Editing-pair datamodule of phase-2 LightControl:

      * editing pairs (json has ``style_zh`` and a ``png`` target): the
        condition jpg resized to 256^2, the Chinese instruction dict
        {"文本描述": "", "指令编辑描述": style_zh, "图片输入": "有"},
        target the png;
      * otherwise self-reconstruction at 128^2 with caption dropout: a
        ``random.Random(seed)`` draw below ``caption_keep_prob`` keeps the
        Chinese caption, else the generic "请描述这张图片" instruction;

    emitting {style_pixels (the target, NHWC in [-1, 1]), cond_pixels,
    gray_pixels} and what the injected ``qwen_process`` returns. Needs
    PIL (the images are decoded and resized with it)."""

    def __init__(self, cfg: DistillDataConfig,
                 qwen_process: Callable,
                 caption_keep_prob: float = 0.1,
                 seed: int = 0):
        """qwen_process(instruction str, PIL image) -> dict of arrays
        (ids / mask and the Qwen vision inputs, see data/qwen_vision.py)."""
        self.cfg = cfg
        self.qwen_process = qwen_process
        self.caption_keep_prob = caption_keep_prob
        self._rng = random.Random(seed)

    @staticmethod
    def _to_tensor(img) -> np.ndarray:
        return np.asarray(img.convert("RGB"), np.float32) / 127.5 - 1.0

    def preproc(self, sample: Dict) -> Dict:
        meta = sample["json"]
        if "style_zh" in meta and "png" in sample:
            target = sample["png"].convert("RGB")
            cond = sample["jpg"].convert("RGB")
            cond_small = cond.resize((256, 256))
            instruction = str({"文本描述": "",
                               "指令编辑描述": meta["style_zh"],
                               "图片输入": "有"})
        else:
            cond = sample["jpg"].convert("RGB")
            target = cond
            cond_small = cond.resize((128, 128))
            if (self._rng.random() < self.caption_keep_prob
                    and "caption_zh" in meta):
                instruction = str({"文本描述": meta["caption_zh"],
                                   "指令编辑描述": "", "图片输入": "有"})
            else:
                instruction = str({"文本描述": "",
                                   "指令编辑描述": "请描述这张图片",
                                   "图片输入": "有"})
        out = {
            "style_pixels": self._to_tensor(target),
            "cond_pixels": self._to_tensor(cond),
            "gray_pixels": self._to_tensor(cond.convert("L")),
        }
        out.update(self.qwen_process(instruction, cond_small))
        return out

    def train_loader(self, device_put: Optional[Callable] = None
                     ) -> PrefetchLoader:
        shards = ShardSampler(self.cfg.urls, seed=self.cfg.seed)
        pipe = (Pipeline(tar_samples(iter(shards)))
                .decode()
                .verify(["json", "jpg"])
                .map(self.preproc)
                .batch(self.cfg.batch_size, stack_collate))
        return PrefetchLoader(pipe, device_put=device_put)


def synthetic_distill_batches(batch_size: int, text_seq_len: int = 512,
                              clip_seq_len: int = 77,
                              mllm_vocab: int = 151674,
                              t5_vocab: int = 32128,
                              clip_vocab: int = 49408,
                              seed: int = 0) -> Iterable[Dict]:
    """Infinite synthetic batches with the DistillDataModule schema."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "mllm_ids": rng.integers(0, mllm_vocab,
                                     (batch_size, text_seq_len),
                                     dtype=np.int32),
            "mllm_mask": np.ones((batch_size, text_seq_len), bool),
            "t5_ids": rng.integers(0, t5_vocab, (batch_size, text_seq_len),
                                   dtype=np.int32),
            "t5_mask": np.ones((batch_size, text_seq_len), bool),
            "clip_ids": rng.integers(0, clip_vocab,
                                     (batch_size, clip_seq_len),
                                     dtype=np.int32),
        }
