"""Greedy decode that exports every step's hidden-state stack, the
counterpart of ``x2i_tpu/models/decoding.py``: the ``use_answer``
reasoning2image conditioning and the multi-turn chat answer, both the
prompt's stack concatenated with the answer's along the sequence.

As JAX's ``lax.scan`` does, the loop runs all ``max_new_tokens`` steps:
a row that has emitted its EOS keeps decoding, and ``valid`` marks the
tokens up to and including the first EOS. Tokens, the finished flags and
positions stay on the device; the loop never reads a value back to the
host, so the host queues the steps ahead of the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from x2i_torch.models.qwen2 import Qwen2LM


@torch.inference_mode()
def greedy_decode_with_hiddens(
        lm: Qwen2LM, inputs_embeds: torch.Tensor,
        attention_mask: torch.Tensor, max_new_tokens: int,
        eos_token_id: int, prefill_rope=None,
        step_pos0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy decode from a prompt of embeddings.

    inputs_embeds (B, S0, H); attention_mask (B, S0), right-padded;
    prefill_rope: optional (cos, sin) tables of the prompt (M-RoPE);
    step_pos0: optional (B,) position of the first decoded token (M-RoPE
    prompts: the largest 3-D position + 1), by default ``sum(mask)``.

    The first token is the argmax at each row's last valid prompt
    position; step i writes slot S0 + i and attends to the prompt's valid
    keys and the slots up to its own.

    -> (prefill_hidden (B, L+1, S0, H), step_hidden (B, L+1, T, H),
    tokens (B, T), valid (B, T)), T = max_new_tokens."""
    b, s0, _ = inputs_embeds.shape
    max_len = s0 + max_new_tokens
    dev = inputs_embeds.device
    mask = attention_mask.bool()
    cache = lm.init_cache(b, max_len)
    prefill_hidden, logits, cache = lm.prefill_cached(
        inputs_embeds, mask, cache, prefill_rope)

    last_pos = mask.long().sum(-1) - 1
    token = logits[torch.arange(b, device=dev), last_pos].argmax(-1)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    pos = mask.long().sum(-1) if step_pos0 is None else step_pos0.long()
    keys = F.pad(mask, (0, max_new_tokens), value=True)
    slots = torch.arange(max_len, device=dev)[None, :]
    steps, tokens, valid = [], [], []
    for i in range(max_new_tokens):
        idx = s0 + i
        hiddens, logits, cache = lm.decode_step(
            lm.embed(token[:, None]), cache, idx, (slots <= idx) & keys,
            pos[:, None])
        steps.append(hiddens[:, :, 0])
        tokens.append(token)
        valid.append(~finished)
        finished = finished | (token == eos_token_id)
        token = logits[:, 0].argmax(-1)
        pos = pos + 1
    return (prefill_hidden, torch.stack(steps, dim=2),
            torch.stack(tokens, dim=1), torch.stack(valid, dim=1))


def concat_answer_hiddens(prefill_hidden: torch.Tensor,
                          step_hidden: torch.Tensor) -> torch.Tensor:
    """The prompt's and the answer's stacks along the sequence: (B, L+1,
    S0 + T, H), the use_answer and multi-turn conditioning."""
    return torch.cat([prefill_hidden, step_hidden], dim=2)
