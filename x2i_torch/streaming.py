"""Streaming chat sessions: chunked prefill and incremental generation,
the counterpart of the LM session of ``x2i_tpu/streaming.py`` (the
reference's ``streaming_prefill`` / ``streaming_generate``). A session
appends each message chunk to a fixed-size KV cache at a tracked offset
(``Qwen2LM.prefill_chunk``), then decodes the assistant's reply token by
token from the cache until a terminator.

The session writes the LM's cache in place (``models/qwen2.py``). The
speech half, ``TTSPipeline``, speaks a reply: ChatTTS audio codes
conditioned on the LM's last hidden state, the DVAE's mel, the vocoder's
waveform (``models/chattts.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch


@dataclasses.dataclass
class StreamingState:
    """The reference's session flags."""
    session_id: Optional[str] = None
    cache: Any = None
    length: int = 0                  # filled cache slots
    last_logits: Any = None          # (1, V) at the last prefilled position
    new_user_msg: bool = True
    llm_generated: bool = False
    llm_generate_completed: bool = False


class StreamingSession:
    """Chunked-prefill chat session over a cached LM.

    llm: a dict of callables
      embed(ids (1, S) int64 on the LM's device) -> (1, S, H)
      prefill_chunk(embeds, cache, index, mask) -> (hidden, logits, cache)
      decode_step(embeds, cache, index, kv_mask, positions)
        -> (hidden, logits, cache)
      init_cache(batch, max_len) -> cache
    and ``device``; tokenize: str -> list[int]; detokenize: list[int] ->
    str."""

    def __init__(self, llm: Dict[str, Any], tokenize: Callable,
                 detokenize: Callable, max_len: int = 2048,
                 terminators: Optional[List[int]] = None):
        self.llm = llm
        self.tokenize = tokenize
        self.detokenize = detokenize
        self.max_len = max_len
        self.terminators = terminators or []
        self.state = StreamingState()

    def _ids(self, ids: List[int]) -> torch.Tensor:
        return torch.tensor([ids], dtype=torch.int64,
                            device=self.llm["device"])

    # -- the reference's role bookkeeping ---------------------------------
    def _wrap_content(self, role: str, content: str, is_first: bool) -> str:
        s = self.state
        if is_first:
            return content                   # caller applies chat template
        if s.new_user_msg and role == "user":
            s.new_user_msg = False
            if s.llm_generated:
                if s.llm_generate_completed:
                    return "<|im_end|>\n<|im_start|>user\n" + content
                # generation was interrupted mid-stream: close the tts turn
                return ("<|tts_eos|><|im_end|>\n<|im_start|>user\n"
                        + content)
            return "<|im_start|>user\n" + content
        return content

    def prefill(self, session_id: str, role: str, content: str,
                embeds: Optional[torch.Tensor] = None) -> str:
        """Append one message chunk to the session's cache.

        content: chat-templated text for the first chunk of a new session,
        raw continuation text otherwise; embeds: optional ready (1, n, H)
        embeddings used instead of tokenizing ``content``.

        Returns the text consumed (after the role bookkeeping)."""
        s = self.state
        is_first = s.session_id != session_id
        if is_first:
            self.state = s = StreamingState(session_id=session_id)
            s.cache = self.llm["init_cache"](1, self.max_len)
        if role in ("system", "assistant"):
            s.new_user_msg = True

        text = self._wrap_content(role, content, is_first)
        if embeds is None:
            ids = self.tokenize(text)
            if not ids:
                return text
            embeds = self.llm["embed"](self._ids(ids))
        n = embeds.shape[1]
        if s.length + n > self.max_len:
            raise ValueError(
                f"session overflow: {s.length}+{n} > {self.max_len}")
        mask = torch.ones((1, n), dtype=torch.bool, device=embeds.device)
        _, logits, s.cache = self.llm["prefill_chunk"](embeds, s.cache,
                                                       s.length, mask)
        s.last_logits = logits[:, n - 1]
        s.length += n
        return text

    def generate(self, max_new_tokens: int = 128,
                 assistant_prompt: str = "<|im_end|>\n<|im_start|>"
                                         "assistant\n"):
        """Greedy-decode the assistant's reply from the session's cache,
        up to a terminator (the reference's ``streaming_generate``).

        Returns (text, token ids, hidden (1, n, H): the final-layer states
        of the generated tokens, None when there are none)."""
        s = self.state
        if s.cache is None:
            raise ValueError("prefill first")
        if assistant_prompt:
            self.prefill(s.session_id, "generate", assistant_prompt)
        s.llm_generated = True
        s.llm_generate_completed = False
        s.new_user_msg = True

        ids: List[int] = []
        hiddens = []
        slots = torch.arange(self.max_len, device=self.llm["device"])[None]
        next_id = int(s.last_logits[0].argmax())
        for _ in range(max_new_tokens):
            if next_id in self.terminators:
                s.llm_generate_completed = True
                break
            ids.append(next_id)
            idx = s.length                    # append slot for this token
            if idx >= self.max_len:
                break
            emb = self.llm["embed"](self._ids([next_id]))
            pos = torch.full((1, 1), idx, dtype=torch.int64,
                             device=slots.device)
            hidden, logits, s.cache = self.llm["decode_step"](
                emb, s.cache, idx, slots <= idx, pos)
            s.length += 1
            s.last_logits = logits[:, -1]
            hiddens.append(hidden[0, -1, 0])
            next_id = int(s.last_logits[0].argmax())
        text = self.detokenize(ids)
        hid = torch.stack(hiddens)[None] if hiddens else None
        return text, ids, hid


def make_qwen2_session(model, tokenize: Callable, detokenize: Callable,
                       max_len: int = 2048,
                       terminators: Optional[List[int]] = None
                       ) -> StreamingSession:
    """A ``StreamingSession`` over a ``Qwen2LM`` (the MiniCPM-o LLM)."""

    def embed(ids):
        with torch.inference_mode():
            return model.embed(ids)

    llm = {"embed": embed, "prefill_chunk": model.prefill_chunk,
           "decode_step": model.decode_step, "init_cache": model.init_cache,
           "device": model.embed_tokens.weight.device}
    return StreamingSession(llm, tokenize, detokenize, max_len, terminators)


class TTSPipeline:
    """Text- and speaker-conditioned speech: ChatTTS codes -> DVAE mel ->
    vocoder waveform (the reference's omni speech path), the counterpart
    of JAX's ``TTSPipeline`` over modules that hold their weights.

    tts: a ``ConditionalChatTTS``; dvae: a ``DVAE``; vocoder: a
    ``VocosVocoder``; tts_tokenize: the TTS side's text tokenizer, str ->
    list[int] (the reference runs a ChatTTS tokenizer over the reply)."""

    def __init__(self, tts, dvae, vocoder, tts_tokenize: Callable,
                 bos_token_id: int = 21134):
        self.tts = tts
        self.dvae = dvae
        self.vocoder = vocoder
        self.tts_tokenize = tts_tokenize
        self.bos_token_id = bos_token_id

    @torch.inference_mode()
    def speak(self, text: str, spk_hidden, draws,
              max_audio_tokens: int = 256, temperature: float = 1.0,
              normalize_numbers: bool = True):
        """-> (waveform (1, samples), audio codes (1, n, num_vq), n).

        spk_hidden: (1, 1, llm_dim), the LM's last final-layer state;
        draws: the (max_audio_tokens, num_vq, num_audio_tokens) Gumbel
        draws of ``ConditionalChatTTS.generate``, or a ``torch.Generator``.
        normalize_numbers: spell digits out per language before
        tokenizing (the reference's streaming TTS does)."""
        tts = self.tts
        cfg, dev = tts.cfg, tts.device
        if normalize_numbers:
            from x2i_torch.data.tts_text import replace_numbers_with_text
            text = replace_numbers_with_text(text)
        reserved = cfg.streaming_text_reserved_len
        ids = self.tts_tokenize(text)[:reserved]
        prefix = [self.bos_token_id] + [cfg.spk_emb_token_id] * (
            cfg.num_spk_embs * int(cfg.use_speaker_embedding))
        input_ids = torch.tensor(
            [prefix + ids + [0] * (reserved - len(ids))], device=dev)
        positions = torch.arange(input_ids.shape[1], device=dev)[None]

        cache = tts.init_cache(cfg.condition_length + max_audio_tokens)
        cache = tts.prefill_text(input_ids, positions, cache, spk_hidden)
        text_mask = torch.arange(reserved, device=dev) < len(ids)
        buf = torch.zeros((1, max_audio_tokens, cfg.num_vq),
                          dtype=torch.int64, device=dev)
        codes, _, n, _ = tts.generate(buf, cache, cfg.condition_length - 1,
                                      text_mask, draws, max_audio_tokens,
                                      temperature=temperature)
        # the generated codes alone: the zero tail would decode to
        # trailing noise
        n = max(n, 1)
        codes = codes[:, :n]
        wav = self.vocoder(self.dvae.decode(codes))
        return wav, codes, n
