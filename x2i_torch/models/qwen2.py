"""Qwen2-family causal LM, the counterpart of ``x2i_tpu/models/qwen2.py``:
the cache-less prefill exporting every hidden state, ``encode_premixed``
(the long-prompt prefill that sums the proj's channel mix layer by layer)
and the decode side over a KV cache (``init_cache``, ``prefill_cached``,
``decode_step``, ``prefill_chunk``), which ``models/decoding.py``,
``multiturn.py`` and ``streaming.py`` drive.

Biases sit on q/k/v but not on o; the head is the tied embedding table,
or with ``tie_word_embeddings=False`` a separate ``lm_head`` (``logits``).
With ``cfg.quantized`` every dense layer, the untied head among them, is
a ``QuantLinear``; the embedding table, the norms and a tied head stay in
``cfg.dtype``. Positions are ``cumsum(mask) - 1`` clipped at 0 unless the
caller passes ``position_ids`` or ready ``rope=(cos, sin)`` tables
(Qwen2.5-VL's M-RoPE); the rotation is applied before the attention
kernel, which sees plain q/k.

The KV cache is a pair (k, v) of (L, B, max_len, Hk, D) tensors in the
LM's dtype. Unlike the JAX functional update, the port writes each
layer's new keys and values into the cache in place and returns the same
pair; ``init_cache`` and the methods that write run under
``torch.inference_mode``. Attention over the cache takes the plain
attention, as JAX takes its XLA path there; the cache-less prefill keeps
the kernel route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import Qwen2Config
from x2i_torch.ops.attention import attention
from x2i_torch.ops.norms import rms_norm
from x2i_torch.ops.quant import make_linear
from x2i_torch.ops.rope import apply_rope_half, rope_freqs_half


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


class Qwen2Block(nn.Module):
    """One decoder layer; with a cache, the layer's (k, v) slices."""

    def __init__(self, cfg: Qwen2Config, device=None):
        super().__init__()
        self.cfg = cfg
        h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        hid, inter, ab = cfg.hidden_size, cfg.intermediate_size, \
            cfg.attention_bias

        dense = make_linear(cfg.quantized, cfg.dtype, cfg.quant_impl)

        def lin(i, o, bias):
            return dense(i, o, bias, device)

        self.input_norm = RMSNorm(hid, cfg.rms_norm_eps, cfg.dtype, device)
        self.q_proj = lin(hid, h * d, ab)
        self.k_proj = lin(hid, hk * d, ab)
        self.v_proj = lin(hid, hk * d, ab)
        self.o_proj = lin(h * d, hid, False)
        self.post_attn_norm = RMSNorm(hid, cfg.rms_norm_eps, cfg.dtype,
                                      device)
        self.gate_proj = lin(hid, inter, False)
        self.up_proj = lin(hid, inter, False)
        self.down_proj = lin(inter, hid, False)

    def forward(self, hidden, cos, sin, kv_mask, cache=None,
                cache_index: int = 0, causal: bool = True,
                causal_offset: int = 0):
        """hidden (B, S, H); cos/sin (B, S, head_dim) or (S, head_dim);
        kv_mask (B, S_kv) over the keys (this call's, or the cache's).
        cache: None, or this layer's (k, v) slices (B, max_len, Hk, D),
        into which k and v are written at ``cache_index`` before the
        attention over the whole cache (query row r's causal diagonal at
        ``causal_offset + r``)."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        x = self.input_norm(hidden)
        q = apply_rope_half(self.q_proj(x).view(b, s, h, d), cos, sin)
        k = apply_rope_half(self.k_proj(x).view(b, s, hk, d), cos, sin)
        v = self.v_proj(x).view(b, s, hk, d)
        if cache is None:
            attn = attention(q, k, v, kv_mask=kv_mask, causal=causal,
                             implementation=cfg.attention_impl)
        else:
            k_cache, v_cache = cache
            k_cache[:, cache_index:cache_index + s] = k
            v_cache[:, cache_index:cache_index + s] = v
            attn = attention(q, k_cache, v_cache, kv_mask=kv_mask,
                             causal=causal, implementation="plain",
                             causal_offset=causal_offset)
        hidden = hidden + self.o_proj(attn.reshape(b, s, h * d))
        x = self.post_attn_norm(hidden)
        return hidden + self.down_proj(F.silu(self.gate_proj(x))
                                       * self.up_proj(x))


class Qwen2LM(nn.Module):
    """Embedding + blocks + final norm (+ an untied head for ``logits``)."""

    def __init__(self, cfg: Qwen2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=cfg.dtype)
        self.layers = nn.ModuleList(Qwen2Block(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  cfg.dtype, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = make_linear(cfg.quantized, cfg.dtype,
                                       cfg.quant_impl)(
                cfg.hidden_size, cfg.vocab_size, False, device)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids)

    def logits(self, hidden):
        """Final norm, then the head: (B, S, H) -> (B, S, vocab)."""
        return self.logits_from_normed(self.final_norm(hidden))

    def logits_from_normed(self, normed):
        if self.cfg.tie_word_embeddings:
            return F.linear(normed, self.embed_tokens.weight)
        return self.lm_head(normed)

    def _prefill_inputs(self, input_ids, attention_mask, inputs_embeds,
                        position_ids, rope):
        """-> (embeddings, bool mask, cos, sin): the given rope tables, or
        f32 tables of ``position_ids`` as ``rope_freqs_half`` builds them,
        by default ``cumsum(mask) - 1`` clipped at 0."""
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s, _ = inputs_embeds.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.bool,
                                        device=inputs_embeds.device)
        attention_mask = attention_mask.bool()
        if rope is not None:
            cos, sin = rope
        else:
            if position_ids is None:
                position_ids = (attention_mask.long().cumsum(-1) - 1
                                ).clamp_min(0)
            cos, sin = rope_freqs_half(position_ids, cfg.head_dim,
                                       cfg.rope_theta)
        return inputs_embeds, attention_mask, cos, sin

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Prefill exporting all hidden states. ``position_ids`` (B, S)
        or ready ``rope`` tables (cos, sin), each (B, S, head_dim) f32 in
        the half layout, replace the default positions.

        Returns (all_hidden (B, L+1, S, H): embeddings, blocks 1..L-1,
        then the final-normed last block -- HF's hidden_states order --,
        last_hidden (B, S, H) final-normed)."""
        inputs_embeds, attention_mask, cos, sin = self._prefill_inputs(
            input_ids, attention_mask, inputs_embeds, position_ids, rope)
        return self._stack(inputs_embeds, cos, sin, attention_mask)

    def _stack(self, hidden, cos, sin, kv_mask, cache=None,
               cache_index: int = 0, causal: bool = True,
               causal_offset: int = 0):
        """The layers over ``hidden`` -> (all_hidden (B, L+1, S, H),
        final-normed last hidden), layer l on the cache's slices l."""
        states = [hidden]
        for i, blk in enumerate(self.layers):
            layer_cache = None if cache is None else (cache[0][i],
                                                      cache[1][i])
            hidden = blk(hidden, cos, sin, kv_mask, layer_cache,
                         cache_index, causal, causal_offset)
            states.append(hidden)
        normed = self.final_norm(hidden)
        states[-1] = normed
        return torch.stack(states, dim=1), normed

    def encode_premixed(self, input_ids, mix_weights, mix_fn,
                        attention_mask: Optional[torch.Tensor] = None,
                        inputs_embeds: Optional[torch.Tensor] = None,
                        position_ids: Optional[torch.Tensor] = None,
                        rope: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None):
        """Prefill with the proj's channel mix summed while the layers
        run: ``Proj.mix`` of the hidden-state stack (plus the conv bias)
        without ever building the (B, L+1, S, H) stack; the extra memory
        is one f32 (B, S, H) accumulator. ``mix_weights`` and ``mix_fn``
        come from ``models/proj.py::streaming_mix_spec``; feed the result
        to ``Proj.mlp``.

        Returns (mixed (B, S, H) f32, last_hidden (B, S, H) final-normed).
        """
        hidden, attention_mask, cos, sin = self._prefill_inputs(
            input_ids, attention_mask, inputs_embeds, position_ids, rope)
        acc = mix_fn(hidden, mix_weights["embed"])
        for blk, w in zip(self.layers, mix_weights["layers"]):
            hidden = blk(hidden, cos, sin, attention_mask)
            acc = acc + mix_fn(hidden, w)
        normed = self.final_norm(hidden)
        acc = acc + mix_fn(normed, mix_weights["final"])
        if mix_weights.get("bias") is not None:
            acc = acc + mix_weights["bias"]
        return acc, normed

    # ------------------------------------------------------------ decode

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int):
        """A zero KV cache: (k, v), each (L, B, max_len, Hk, D) in the
        LM's dtype on its device."""
        cfg = self.cfg
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        dev = self.embed_tokens.weight.device
        return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
                torch.zeros(shape, dtype=cfg.dtype, device=dev))

    @torch.inference_mode()
    def prefill_cached(self, inputs_embeds, attention_mask, cache,
                       rope=None):
        """The prefill that also fills cache slots [0, S), for a decode
        to continue from. rope: optional ready (cos, sin) tables (M-RoPE);
        else the default positions. The keys are the prompt mask padded
        with False to max_len. -> (all_hidden (B, L+1, S, H), logits (B,
        S, vocab), cache)."""
        b, s, _ = inputs_embeds.shape
        _, mask, cos, sin = self._prefill_inputs(None, attention_mask,
                                                 inputs_embeds, None, rope)
        kv_mask = F.pad(mask, (0, cache[0].shape[2] - s), value=False)
        all_hidden, normed = self._stack(inputs_embeds, cos, sin, kv_mask,
                                         cache, 0, causal=True)
        return all_hidden, self.logits_from_normed(normed), cache

    @torch.inference_mode()
    def decode_step(self, token_embeds, cache, cache_index: int, kv_mask,
                    position_ids):
        """One decode step: token_embeds (B, 1, H) written at slot
        ``cache_index``; kv_mask (B, max_len) the valid keys, the token
        just written among them; position_ids (B, 1). -> (all_hidden (B,
        L+1, 1, H), logits (B, 1, vocab), cache)."""
        cfg = self.cfg
        cos, sin = rope_freqs_half(position_ids, cfg.head_dim,
                                   cfg.rope_theta)
        all_hidden, normed = self._stack(token_embeds, cos, sin,
                                         kv_mask.bool(), cache, cache_index,
                                         causal=False)
        return all_hidden, self.logits_from_normed(normed), cache

    @torch.inference_mode()
    def prefill_chunk(self, inputs_embeds, cache, cache_index: int,
                      chunk_mask):
        """A prefill chunk (B, S) written at slot ``cache_index`` (a
        streaming session's next message): positions ``cache_index +
        cumsum(chunk_mask) - 1`` (clipped), queries that see every earlier
        slot and the chunk's valid keys up to their own position.
        chunk_mask (B, S): the chunk's valid tokens, right-padded. ->
        (all_hidden, logits, cache)."""
        cfg = self.cfg
        s = inputs_embeds.shape[1]
        chunk_mask = chunk_mask.bool()
        position_ids = cache_index + (chunk_mask.long().cumsum(-1) - 1
                                      ).clamp_min(0)
        cos, sin = rope_freqs_half(position_ids, cfg.head_dim,
                                   cfg.rope_theta)
        pos = torch.arange(cache[0].shape[2],
                           device=inputs_embeds.device)[None, :]
        rel = pos - cache_index
        in_chunk = (rel >= 0) & (rel < s)
        kv_mask = (pos < cache_index) | (
            in_chunk & chunk_mask[:, rel[0].clamp(0, s - 1)])
        all_hidden, normed = self._stack(inputs_embeds, cos, sin, kv_mask,
                                         cache, cache_index, causal=True,
                                         causal_offset=cache_index)
        return all_hidden, self.logits_from_normed(normed), cache
