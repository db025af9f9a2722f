"""Multi-turn conversational image generation, the counterpart of
``x2i_tpu/multiturn.py``: a session keeps the chat history; each turn the
LM answers greedily, the prompt's and the answer's hidden states are
concatenated along the sequence, projected, and an image is made with a
fixed seed, so that successive turns refine one latent trajectory.

Differences from JAX: the session holds modules (the LM, the proj), not
apply functions with their params; ``build_random_session`` hashes
characters with crc32 (stable across processes) where JAX uses Python's
``hash``; ``build_session_from_checkpoints`` takes a ``tokenizer``, as
the port's loader does.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from x2i_torch.models.decoding import (concat_answer_hiddens,
                                       greedy_decode_with_hiddens)
from x2i_torch.models.qwen2 import Qwen2LM


@dataclasses.dataclass
class ChatTurn:
    user: str
    assistant: str


class MultiTurnSession:
    """Chat-conditioned generation.

    tokenize(history: List[ChatTurn], user_msg) -> (ids, mask), (1, S)
    arrays of the whole chat prompt; detokenize(token ids) -> str;
    proj(stack (B, C, S, H)) -> (pooled, prompt_embeds);
    generate_image(pooled, prompt_embeds, seed=...) -> images. The
    reference decodes 128 tokens and fixes the seed at 0."""

    def __init__(self, lm: Qwen2LM, tokenize: Callable,
                 detokenize: Callable, proj: Callable,
                 generate_image: Callable, eos_token_id: int,
                 max_new_tokens: int = 128, seed: int = 0):
        self.lm = lm
        self.tokenize = tokenize
        self.detokenize = detokenize
        self.proj = proj
        self.generate_image = generate_image
        self.eos_token_id = eos_token_id
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.history: List[ChatTurn] = []

    def turn(self, user_msg: str) -> Tuple[str, Any]:
        """One conversation turn -> (assistant text, image): the answer
        is appended to the history, and the image is conditioned on the
        prompt's hidden states, then the answer's, all
        ``max_new_tokens`` steps of it."""
        ids, mask = self.tokenize(self.history, user_msg)
        dev = self.lm.embed_tokens.weight.device
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(ids), device=dev)
            mask = torch.as_tensor(np.asarray(mask, bool), device=dev)
            prefill, steps, tokens, valid = greedy_decode_with_hiddens(
                self.lm, self.lm.embed(ids), mask, self.max_new_tokens,
                self.eos_token_id)
            answer = self.detokenize(tokens[0][valid[0]].cpu().numpy())
            self.history.append(ChatTurn(user=user_msg, assistant=answer))
            pooled, prompt_embeds = self.proj(
                concat_answer_hiddens(prefill, steps))
        return answer, self.generate_image(pooled, prompt_embeds,
                                           seed=self.seed)

    def reset(self) -> None:
        self.history = []


def build_random_session(seed: int = 0, max_new_tokens: int = 8,
                         gen_cfg=None, device=None,
                         dtype=torch.bfloat16) -> MultiTurnSession:
    """A session over the tiny random-weight pipeline: the whole path
    (history -> chat prompt -> decode -> stacks -> proj -> image) without
    checkpoints; prompts of 64 tokens, EOS id 1."""
    from x2i_torch.pipeline import build_random_pipeline

    pipe = build_random_pipeline("tiny", seed=seed, gen_cfg=gen_cfg,
                                 device=device, dtype=dtype)
    ctx = pipe._random_ctx
    vocab, seq = ctx["lm_cfg"].vocab_size, 64

    def tokenize(history: List[ChatTurn], user_msg: str):
        text = "".join(f"<u>{t.user}<a>{t.assistant}" for t in history)
        text += f"<u>{user_msg}<a>"
        toks = [zlib.crc32(c.encode()) % vocab for c in text][-seq:]
        ids = np.zeros((1, seq), np.int64)
        ids[0, :len(toks)] = toks
        mask = np.zeros((1, seq), bool)
        mask[0, :max(len(toks), 1)] = True
        return ids, mask

    def detokenize(token_ids) -> str:
        return " ".join(f"t{int(t)}" for t in token_ids)

    return MultiTurnSession(
        lm=ctx["lm"], tokenize=tokenize, detokenize=detokenize,
        proj=pipe.proj, generate_image=pipe.generate, eos_token_id=1,
        max_new_tokens=max_new_tokens, seed=seed)


def chat_tokenize(tok):
    """tokenize(history, user_msg) over an HF-style tokenizer: the
    history's user and assistant turns and the new user message through
    its chat template, with the generation prompt."""

    def tokenize(history: List[ChatTurn], user_msg: str):
        msgs = []
        for t in history:
            msgs.append({"role": "user", "content": t.user})
            msgs.append({"role": "assistant", "content": t.assistant})
        msgs.append({"role": "user", "content": user_msg})
        enc = tok(tok.apply_chat_template(msgs, tokenize=False,
                                          add_generation_prompt=True))
        return (np.asarray([enc["input_ids"]], np.int64),
                np.asarray([enc["attention_mask"]], bool))

    return tokenize


def build_session_from_checkpoints(model: str, flux_path: str,
                                   mllm_path: str, proj_path: str,
                                   num_steps: int = 4, height: int = 1024,
                                   width: int = 1024, seed: int = 0,
                                   max_new_tokens: int = 128,
                                   quantized="w8", device=None,
                                   tokenizer=None) -> MultiTurnSession:
    """A session over checkpoints (``build_pipeline_from_checkpoints``,
    whose ``device`` and ``tokenizer`` it takes): the model's own chat
    template over the history, the tokenizer's decode of the answer, the
    encoder's EOS id."""
    from x2i_torch.convert.load import build_pipeline_from_checkpoints

    pipe = build_pipeline_from_checkpoints(
        model, flux_path, mllm_path, proj_path, num_steps=num_steps,
        height=height, width=width, seed=seed, quantized=quantized,
        device=device, tokenizer=tokenizer)
    ctx = pipe.encoder_fn.ctx
    tok = ctx["tokenizer"]
    return MultiTurnSession(
        lm=ctx["lm"], tokenize=chat_tokenize(tok),
        detokenize=lambda ids: tok.decode(list(ids),
                                          skip_special_tokens=True),
        proj=pipe.proj, generate_image=pipe.generate,
        eos_token_id=ctx["eos_token_id"], max_new_tokens=max_new_tokens,
        seed=seed)
