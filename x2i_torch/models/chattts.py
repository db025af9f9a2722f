"""MiniCPM-o's speech half, the counterpart of ``x2i_tpu/models/chattts.py``:
the ChatTTS audio-code GPT (``ConditionalChatTTS``), the DVAE mel codec
with grouped residual FSQ, and the Vocos vocoder with its inverse-STFT
head. The reference is MiniCPM-o's ``modeling_minicpmo.py`` (the
ConvNeXt block, GFSQ, DVAE, ConditionalChatTTS, its streaming chunk
masks and projector).

Sequence format: [Stts bos] [spk emb x N] [text tokens, a fixed reserved
length] [Ptts audio-bos] [audio tokens ...]. An audio token's embedding
sums ``num_vq`` codebook embeddings; its logits come from ``num_vq``
weight-normed heads. Streaming: audio chunk k attends only the first
k * text_chunk prefilled text tokens (``make_generation_kv_mask``).

Layout: the public methods take and return channels-last (B, T, C)
tensors, as the JAX package does; the convolutions run over (B, C, T),
PyTorch's layout, with one transpose at each end.

The GPT is the port's ``Qwen2Block`` stack over a KV cache written in
place (``models/qwen2.py``), in the plain attention: JAX turns its Pallas
attention off here. ``generate`` takes its random draws from the caller:
a (max_new_tokens, num_vq, num_audio_tokens) f32 Gumbel tensor (JAX's
``jax.random.categorical`` is the argmax of the logits plus such a draw),
or a ``torch.Generator`` from which it draws the same shapes. Its loop
stops at the step that emits eos; JAX's ``fori_loop`` runs on to
``max_new_tokens`` and writes those steps into the cache past ``n``, so
the returned cache differs there, while the codes and ``n`` are JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from x2i_torch.core.config import Qwen2Config
from x2i_torch.models.clip import LayerNorm
from x2i_torch.models.qwen2 import Qwen2Block, RMSNorm
from x2i_torch.ops.rope import rope_freqs_half


@dataclasses.dataclass(frozen=True)
class ChatTTSConfig:
    """The reference's ConditionalChatTTSConfig, JAX's defaults."""

    llm_dim: int = 3584              # MiniCPM-o-2.6's LLM width
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_attention_heads: int = 12
    num_hidden_layers: int = 20
    max_position_embeddings: int = 4096
    num_audio_tokens: int = 626
    num_text_tokens: int = 21178
    num_mel_bins: int = 100
    num_vq: int = 4
    use_speaker_embedding: bool = True
    spk_emb_token_id: int = 21143
    num_spk_embs: int = 1
    audio_bos_token_id: int = 21132
    text_eos_token_id: int = 21133
    streaming_text_chunk_size: int = 10
    streaming_text_reserved_len: int = 300
    streaming_audio_chunk_size: int = 50
    use_mlp: bool = True
    top_p: float = 0.7
    top_k: int = 20
    repetition_penalty: float = 1.0
    repetition_window: int = 16
    dtype: Any = torch.float32

    @property
    def backbone(self) -> Qwen2Config:
        """The TTS GPT is a plain Llama: no attention bias, no GQA, the
        plain attention (JAX's ``use_pallas_attention=False``)."""
        return Qwen2Config(
            vocab_size=self.num_text_tokens,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_attention_heads,
            head_dim=self.hidden_size // self.num_attention_heads,
            attention_bias=False, rope_theta=10000.0, dtype=self.dtype,
            attention_impl="plain")

    @property
    def condition_length(self) -> int:
        """bos + spk embs + reserved text + audio bos."""
        return (1 + self.num_spk_embs * int(self.use_speaker_embedding)
                + self.streaming_text_reserved_len + 1)


class MultiModalProjector(nn.Module):
    """linear -> relu -> linear."""

    def __init__(self, in_dim: int, out_dim: int, dtype, device=None):
        super().__init__()
        self.linear1 = nn.Linear(in_dim, out_dim, device=device, dtype=dtype)
        self.linear2 = nn.Linear(out_dim, out_dim, device=device,
                                 dtype=dtype)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


# ---------------------------------------------------------------------------
# DVAE: a ConvNeXt codec with grouped residual FSQ
# ---------------------------------------------------------------------------


def _conv1d(cin, cout, k, dtype, device, bias=True, **kw):
    """flax's "SAME" padding for the odd kernels used here."""
    kw.setdefault("padding", kw.get("dilation", 1) * (k // 2))
    return nn.Conv1d(cin, cout, k, bias=bias, device=device, dtype=dtype,
                     **kw)


class ConvNeXt1DBlock(nn.Module):
    """Depthwise dilated conv1d -> LayerNorm (eps 1e-6) -> Linear -> erf
    GELU -> Linear -> layer scale ``coef`` + residual, over (B, C, T)."""

    def __init__(self, dim: int, intermediate_dim: int, kernel: int,
                 dilation: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dwconv = _conv1d(dim, dim, kernel, dtype, device,
                              dilation=dilation, groups=dim)
        self.norm = LayerNorm(dim, 1e-6, dtype, device)
        self.pwconv1 = nn.Linear(dim, intermediate_dim, device=device,
                                 dtype=dtype)
        self.pwconv2 = nn.Linear(intermediate_dim, dim, device=device,
                                 dtype=dtype)
        self.coef = nn.Parameter(torch.full((dim,), 1e-6, dtype=dtype,
                                            device=device))

    def forward(self, x):                               # (B, C, T)
        y = self.norm(self.dwconv(x).transpose(1, 2))
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + (y * self.coef).transpose(1, 2)


class DVAEDecoder(nn.Module):
    """conv_in (idim -> bn -> hidden) -> n ConvNeXt blocks -> conv_out,
    over (B, C, T)."""

    def __init__(self, idim: int, odim: int, n_layer: int = 12,
                 bn_dim: int = 64, hidden: int = 256, kernel: int = 7,
                 dilation: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        self.n_layer = n_layer
        self.conv_in0 = _conv1d(idim, bn_dim, 3, dtype, device)
        self.conv_in1 = _conv1d(bn_dim, hidden, 3, dtype, device)
        for i in range(n_layer):
            self.add_module(f"block_{i}", ConvNeXt1DBlock(
                hidden, hidden * 4, kernel, dilation, dtype, device))
        self.conv_out = _conv1d(hidden, odim, 1, dtype, device, bias=False)

    def forward(self, x):                               # (B, C, T)
        y = self.conv_in1(F.gelu(self.conv_in0(x)))
        for i in range(self.n_layer):
            y = getattr(self, f"block_{i}")(y)
        return self.conv_out(y)


def _fsq_basis(levels: Sequence[int], device=None) -> torch.Tensor:
    basis = [1]
    for lv in levels[:-1]:
        basis.append(basis[-1] * lv)
    return torch.tensor(basis, dtype=torch.int64, device=device)


def fsq_indices_to_codes(indices: torch.Tensor,
                         levels: Sequence[int]) -> torch.Tensor:
    """FSQ codebook lookup: an index -> per-dimension centred codes in
    [-1, 1] (vector_quantize_pytorch's ``FSQ.indices_to_codes``)."""
    lv = torch.tensor(levels, dtype=torch.int64, device=indices.device)
    half = lv // 2
    codes = torch.div(indices.long()[..., None],
                      _fsq_basis(levels, indices.device),
                      rounding_mode="floor") % lv
    return (codes - half).float() / half.float()


def fsq_codes_to_indices(codes: torch.Tensor,
                         levels: Sequence[int]) -> torch.Tensor:
    half = torch.tensor(levels, device=codes.device) // 2
    scaled = torch.round(codes * half.float() + half.float()).long()
    return (scaled * _fsq_basis(levels, codes.device)).sum(-1)


def fsq_quantize(z: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Bounded round-to-level quantization (``FSQ.quantize``): a tanh
    bound to the level range, round (half to even), rescale to [-1, 1]."""
    lv = torch.tensor(levels, dtype=torch.float32, device=z.device)
    half_l = (lv - 1) * (1 + 1e-3) / 2
    offset = torch.tensor([0.5 if v % 2 == 0 else 0.0 for v in levels],
                          device=z.device)
    shift = torch.atanh(offset / half_l)
    bounded = torch.tanh(z + shift) * half_l - offset
    half_width = torch.tensor([v // 2 for v in levels], dtype=torch.float32,
                              device=z.device)
    return torch.round(bounded) / half_width


class GroupedResidualFSQ(nn.Module):
    """G groups x R residual FSQ quantizers over the channels, each group
    with its own in and out projections (vector_quantize_pytorch's
    GroupedResidualFSQ as the reference's GFSQ builds it: dim 1024,
    levels (5, 5, 5, 5), G = 2, R = 2). Residual quantizer r scales by
    (levels - 1)^-r."""

    def __init__(self, dim: int, levels: Tuple[int, ...], groups: int,
                 num_quantizers: int, dtype=torch.float32, device=None):
        super().__init__()
        self.levels, self.groups = tuple(levels), groups
        self.num_quantizers = num_quantizers
        d, cd = dim // groups, len(levels)
        for g in range(groups):
            self.add_module(f"project_in_{g}", nn.Linear(
                d, cd, device=device, dtype=dtype))
            self.add_module(f"project_out_{g}", nn.Linear(
                cd, d, device=device, dtype=dtype))

    def _scales(self, device):
        lv = torch.tensor(self.levels, dtype=torch.float32,
                          device=device) - 1.0
        return [lv ** (-float(r)) for r in range(self.num_quantizers)]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, dim) -> indices (B, T, groups * num_quantizers)."""
        scales = self._scales(x.device)
        out = []
        for g, xg in enumerate(x.chunk(self.groups, dim=-1)):
            residual = getattr(self, f"project_in_{g}")(xg)
            for r in range(self.num_quantizers):
                q = fsq_quantize(residual / scales[r], self.levels)
                out.append(fsq_codes_to_indices(q, self.levels))
                residual = residual - q * scales[r]
        return torch.stack(out, dim=-1)

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (B, T, groups * num_quantizers) -> (B, T, dim)."""
        scales = self._scales(indices.device)
        outs = []
        for g in range(self.groups):
            total = 0.0
            for r in range(self.num_quantizers):
                ind = indices[..., g * self.num_quantizers + r]
                total = total + fsq_indices_to_codes(
                    ind, self.levels) * scales[r]
            proj = getattr(self, f"project_out_{g}")
            outs.append(proj(total.to(proj.weight.dtype)))
        return torch.cat(outs, dim=-1)


class DVAE(nn.Module):
    """The mel codec: mel / coef -> a stride-2 downsampling conv ->
    encoder -> FSQ indices; indices -> FSQ features -> the two halves
    interleaved along time -> decoder -> out conv -> mel * coef.

    ``quantizer=False`` builds it without the FSQ projections, for a
    checkpoint that lacks them; ``encode`` and ``decode`` then raise."""

    def __init__(self, dtype=torch.float32, device=None,
                 quantizer: bool = True):
        super().__init__()
        self.coef = nn.Parameter(torch.ones(100, dtype=torch.float32,
                                            device=device))
        self.down0 = _conv1d(100, 512, 3, dtype, device)
        self.down1 = _conv1d(512, 512, 4, dtype, device, stride=2,
                             padding=1)
        self.encoder = DVAEDecoder(512, 1024, n_layer=12, bn_dim=128,
                                   hidden=256, dtype=dtype, device=device)
        self.decoder = DVAEDecoder(512, 512, n_layer=12, bn_dim=128,
                                   hidden=256, dtype=dtype, device=device)
        self.out_conv = _conv1d(512, 100, 3, dtype, device, bias=False)
        self.vq = (GroupedResidualFSQ(1024, (5, 5, 5, 5), 2, 2, dtype,
                                      device) if quantizer else None)

    def _quantizer(self) -> GroupedResidualFSQ:
        if self.vq is None:
            raise ValueError("this DVAE was built without its quantizer "
                             "(a checkpoint without vq_layer)")
        return self.vq

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, 100) -> indices (B, T // 2, 4)."""
        vq = self._quantizer()
        x = (mel / self.coef).transpose(1, 2)
        x = F.gelu(self.down1(F.gelu(self.down0(x))))
        return vq.encode(self.encoder(x).transpose(1, 2))

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (B, T, 4) -> mel (B, 2T, 100)."""
        feats = self._quantizer().decode(indices)       # (B, T, 1024)
        b, t, _ = feats.shape
        # frame t emits [half0_t, half1_t]: the reference's
        # view(B, 2, 512, T).permute(0, 2, 3, 1).flatten(2)
        feats = feats.reshape(b, 2 * t, 512).transpose(1, 2)
        mel = self.out_conv(self.decoder(feats)).transpose(1, 2)
        return mel * self.coef

    def forward(self, indices):
        return self.decode(indices)

    def encode_decode(self, mel):
        return self.decode(self.encode(mel))


# ---------------------------------------------------------------------------
# The Vocos vocoder: a ConvNeXt backbone and an inverse-STFT head
# ---------------------------------------------------------------------------


class VocosVocoder(nn.Module):
    """Mel -> waveform: ChatTTS's shipped Vocos (a backbone of input 100,
    dim 512, intermediate 1536, 8 layers; an ISTFT head with n_fft 1024,
    hop 256, centred). The inverse real DFT is one matrix product with
    JAX's cosine and sine bases, the window the symmetric Hann window
    (``jnp.hanning``), then overlap-add over the summed squared window."""

    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 n_fft: int = 1024, hop_length: int = 256,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_layers, self.n_fft, self.hop_length = (num_layers, n_fft,
                                                        hop_length)
        self.embed = _conv1d(input_channels, dim, 7, dtype, device)
        self.norm_in = LayerNorm(dim, 1e-6, dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", ConvNeXt1DBlock(
                dim, intermediate_dim, 7, 1, dtype, device))
        self.norm_out = LayerNorm(dim, 1e-6, dtype, device)
        self.head = nn.Linear(dim, n_fft + 2, device=device, dtype=dtype)

    def _bases(self, device):
        """(cos_b, sin_b), each (n_fft / 2 + 1, n_fft) f32, weighted by
        (2 - [k in {0, n/2}]) / n, as JAX builds them."""
        nf = self.n_fft
        k = torch.arange(nf // 2 + 1, dtype=torch.float32,
                         device=device)[:, None]
        t = torch.arange(nf, dtype=torch.float32, device=device)[None, :]
        w = torch.where((k == 0) | (k == nf // 2), 1.0, 2.0) / nf
        ang = 2 * math.pi * k * t / nf
        return w * torch.cos(ang), w * torch.sin(ang)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, input_channels) -> audio (B, (T - 1) * hop)."""
        x = self.embed(mel.transpose(1, 2))
        x = self.norm_in(x.transpose(1, 2)).transpose(1, 2)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        h = self.head(self.norm_out(x.transpose(1, 2)))  # (B, T, n_fft+2)
        mag, phase = h.chunk(2, dim=-1)
        mag = torch.exp(mag.clamp(max=10.0)).float()
        phase = phase.float()
        cos_b, sin_b = self._bases(h.device)
        frames = (mag * torch.cos(phase)) @ cos_b \
            - (mag * torch.sin(phase)) @ sin_b          # (B, T, n_fft)
        window = torch.hann_window(self.n_fft, periodic=False,
                                   dtype=torch.float32, device=h.device)
        frames = frames * window

        b, t, nf = frames.shape
        out_len = (t - 1) * self.hop_length + nf
        fold = dict(output_size=(1, out_len), kernel_size=(1, nf),
                    stride=(1, self.hop_length))
        audio = F.fold(frames.transpose(1, 2), **fold)[:, 0, 0]
        env = F.fold((window ** 2)[None, :, None].expand(1, nf, t),
                     **fold)[0, 0, 0]
        audio = audio / env.clamp_min(1e-8)
        pad = nf // 2                                   # the centre trim
        return audio[:, pad:-pad]


# ---------------------------------------------------------------------------
# ConditionalChatTTS: the LLM-conditioned streaming audio-code GPT
# ---------------------------------------------------------------------------


def make_generation_kv_mask(cfg: ChatTTSConfig, text_mask: torch.Tensor,
                            kv_len: int, past_seen: int,
                            seq_end: Optional[int] = None) -> torch.Tensor:
    """The cache positions an audio query may attend (the reference's
    ``make_streaming_chunk_mask_generation``): always the bos and spk
    prefix and the audio region; of the text only the first
    ceil((past - reserved) / audio_chunk) * text_chunk prefilled tokens.
    The [Ptts] audio-bos slot (prefix + reserved) is never visible.

    text_mask: (reserved_len,) bool, the prefilled text positions.
    past_seen drives the visible text; seq_end (default past_seen) bounds
    the attended extent: a chunked audio prefill passes the length before
    the chunk as past_seen and the chunk's end as seq_end.
    Returns (1, kv_len) bool."""
    prefix = 1 + cfg.num_spk_embs * int(cfg.use_speaker_embedding)
    reserved = cfg.streaming_text_reserved_len
    pos = torch.arange(kv_len, device=text_mask.device)
    # JAX's f32 ceil of (past - reserved) / audio_chunk, exact in integers
    chunks = -((reserved - past_seen) // cfg.streaming_audio_chunk_size)
    visible_text_end = prefix + min(chunks * cfg.streaming_text_chunk_size,
                                    reserved)
    in_text = (pos >= prefix) & (pos < prefix + reserved)
    padded = F.pad(text_mask.bool(), (prefix, kv_len - prefix - reserved),
                   value=True)
    mask = ~in_text | ((pos < visible_text_end) & padded)
    mask = mask & (pos != prefix + reserved)
    end = past_seen if seq_end is None else seq_end
    return (mask & (pos <= end))[None, :]


Draws = Union[torch.Tensor, torch.Generator]


class ConditionalChatTTS(nn.Module):
    """The TTS GPT: a Llama (the port's ``Qwen2Block`` without biases)
    with text embeddings, ``num_vq`` summed audio-code embeddings, an
    LLM -> TTS speaker projector and ``num_vq`` weight-normed heads
    ``head_v_i`` (num_audio_tokens, hidden) and ``head_g_i``
    (num_audio_tokens,), in torch's weight_norm layout: w = g v / |v| over
    the input axis."""

    # the leaves a JAX tree holds as (in, out): the bridge transposes them
    flax_transposed = ("head_v_",)

    def __init__(self, cfg: ChatTTSConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt, h = cfg.dtype, cfg.hidden_size
        self.emb_text = nn.Embedding(cfg.num_text_tokens, h, device=device,
                                     dtype=dt)
        for i in range(cfg.num_vq):
            self.add_module(f"emb_code_{i}", nn.Embedding(
                cfg.num_audio_tokens, h, device=device, dtype=dt))
        self.projector = (
            MultiModalProjector(cfg.llm_dim, h, dt, device) if cfg.use_mlp
            else nn.Linear(cfg.llm_dim, h, bias=False, device=device,
                           dtype=dt))
        backbone = cfg.backbone
        self.blocks = nn.ModuleList(Qwen2Block(backbone, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(h, 1e-6, dt, device)
        for i in range(cfg.num_vq):
            self.register_parameter(f"head_v_{i}", nn.Parameter(torch.empty(
                cfg.num_audio_tokens, h, device=device, dtype=dt)))
            self.register_parameter(f"head_g_{i}", nn.Parameter(torch.ones(
                cfg.num_audio_tokens, device=device, dtype=dt)))

    @property
    def device(self) -> torch.device:
        return self.emb_text.weight.device

    # -- embeddings ------------------------------------------------------
    def embed_text(self, input_ids, spk_hidden=None):
        """Text embeddings, the spk token's slot replaced by the
        projected, L2-normalised LLM hidden state."""
        cfg = self.cfg
        emb = self.emb_text(input_ids)
        if spk_hidden is not None and cfg.use_speaker_embedding:
            proj = self.projector(spk_hidden.to(emb.device, cfg.dtype))
            proj = proj / torch.linalg.vector_norm(proj, dim=-1,
                                                   keepdim=True)
            is_spk = input_ids == cfg.spk_emb_token_id
            emb = torch.where(is_spk[..., None], proj[:, :1].to(emb.dtype),
                              emb)
        return emb

    def embed_code(self, audio_ids):
        """audio_ids (B, S, num_vq) -> the summed code embeddings."""
        out = 0.0
        for i in range(self.cfg.num_vq):
            out = out + getattr(self, f"emb_code_{i}")(audio_ids[..., i])
        return out

    def code_logits(self, hidden):
        """(B, S, H) -> (B, S, num_audio_tokens, num_vq)."""
        outs = []
        for i in range(self.cfg.num_vq):
            v = getattr(self, f"head_v_{i}")
            g = getattr(self, f"head_g_{i}")
            w = v * (g / torch.linalg.vector_norm(v, dim=1))[:, None]
            outs.append(F.linear(hidden.to(w.dtype), w))
        return torch.stack(outs, dim=-1)

    # -- the cache -------------------------------------------------------
    @torch.inference_mode()
    def init_cache(self, max_len: int):
        """A zero KV cache (k, v), each (L, 1, max_len, heads, head_dim)."""
        cfg = self.cfg.backbone
        shape = (cfg.num_hidden_layers, 1, max_len, cfg.num_key_value_heads,
                 cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    def _run(self, embeds, positions, kv_mask, cache, cache_index: int,
             causal: bool):
        cfg = self.cfg.backbone
        cos, sin = rope_freqs_half(positions, cfg.head_dim, cfg.rope_theta)
        hidden = embeds
        for i, blk in enumerate(self.blocks):
            hidden = blk(hidden, cos, sin, kv_mask, (cache[0][i],
                                                     cache[1][i]),
                         cache_index, causal, cache_index)
        return self.norm(hidden), cache

    @torch.inference_mode()
    def prefill_text(self, input_ids, positions, cache, spk_hidden=None):
        """Write a chunk of text tokens into the cache. positions (B, S):
        their slots, consecutive, in the reserved text region. -> cache."""
        embeds = self.embed_text(input_ids, spk_hidden)
        kv_len = cache[0].shape[2]
        kv_mask = (torch.arange(kv_len, device=embeds.device)[None, :]
                   <= positions[:, -1:])
        _, cache = self._run(embeds, positions, kv_mask, cache,
                             int(positions[0, 0]), causal=True)
        return cache

    @torch.inference_mode()
    def prefill_audio(self, audio_ids, cache, cache_index: int, text_mask):
        """Prefill audio codes (B, S, num_vq) at ``cache_index`` (the
        reference's sliding-window continuation), the audio-bos embedding
        prepended. -> cache."""
        bos = self.emb_text(torch.full((audio_ids.shape[0], 1),
                                       self.cfg.audio_bos_token_id,
                                       device=self.device))
        embeds = torch.cat([bos, self.embed_code(audio_ids)], dim=1)
        s = embeds.shape[1]
        positions = cache_index + torch.arange(s, device=self.device)[None]
        kv_mask = make_generation_kv_mask(
            self.cfg, text_mask, cache[0].shape[2], cache_index,
            seq_end=cache_index + s - 1)
        _, cache = self._run(embeds, positions, kv_mask, cache, cache_index,
                             causal=True)
        return cache

    @torch.inference_mode()
    def decode_step(self, embeds, cache, cache_index: int, text_mask):
        """One step (B, 1, H) written at ``cache_index`` -> (logits (B,
        num_audio_tokens, num_vq), cache)."""
        positions = torch.full((embeds.shape[0], 1), cache_index,
                               device=embeds.device)
        kv_mask = make_generation_kv_mask(self.cfg, text_mask,
                                          cache[0].shape[2], cache_index)
        hidden, cache = self._run(embeds, positions, kv_mask, cache,
                                  cache_index, causal=False)
        return self.code_logits(hidden)[:, -1], cache

    # -- sampling --------------------------------------------------------
    def filter_logits(self, logits, window, window_valid, step: int,
                      min_new_tokens: int, temperature: float):
        """One step's logits (1, V, num_vq) -> the filtered f32 logits
        (num_vq, V): the repetition penalty (penalty ** count over the
        valid ``window`` (num_vq, win) codes, skipped at 1.0),
        temperature, eos masked before ``min_new_tokens``, top-k (ties
        with the k-th survive) and top-p, as JAX's ``sample_heads``."""
        cfg = self.cfg
        eos = cfg.num_audio_tokens - 1
        v = logits.shape[1]
        lg = logits[0].T.float()
        if cfg.repetition_penalty != 1.0:
            onehot = F.one_hot(window.long(), v).float()  # (num_vq, win, V)
            count = (onehot * window_valid[None, :, None]).sum(1)
            factor = torch.pow(cfg.repetition_penalty, count)
            lg = torch.where(lg > 0, lg / factor, lg * factor)
        lg = lg / temperature
        if step < min_new_tokens:
            lg[:, eos] = -math.inf
        kth = lg.sort(dim=-1).values[:, -cfg.top_k][:, None]
        lg = torch.where(lg < kth, -math.inf, lg)
        probs = torch.softmax(lg, dim=-1)
        sorted_p = probs.sort(dim=-1, descending=True).values
        cut = (sorted_p.cumsum(-1) < cfg.top_p).sum(-1, keepdim=True)
        # past the end JAX's take_along_axis gives NaN and cuts nothing;
        # the last (smallest) probability cuts nothing either
        cutoff = sorted_p.gather(-1, cut.clamp(max=v - 1))
        return torch.where(probs < cutoff, -math.inf, lg)

    @torch.inference_mode()
    def generate(self, audio_ids, cache, cache_index: int, text_mask,
                 draws: Draws, max_new_tokens: int, min_new_tokens: int = 10,
                 temperature: float = 1.0):
        """Sample audio codes step by step: embed the previous step's
        codes (the audio-bos on the very first audio position), run one
        cached step, filter (``filter_logits``), and take the argmax of
        the filtered logits plus the step's Gumbel draw: ``draws[i]``
        (num_vq, V) of a (max_new_tokens, num_vq, V) f32 tensor, or drawn
        from a ``torch.Generator``.

        audio_ids: (1, S_buf, num_vq) buffer the codes are written into (a
        copy is returned). The loop stops when any codebook emits eos;
        that step's codes are written at slot n and n does not advance,
        so the valid codes are [0, n). -> (audio_ids, cache, n, finished).
        """
        cfg = self.cfg
        eos = cfg.num_audio_tokens - 1
        dev = self.device
        audio_ids = audio_ids.to(dev).clone()
        text_mask = text_mask.to(dev)
        win = min(cfg.repetition_window, audio_ids.shape[1])
        shape = (cfg.num_vq, cfg.num_audio_tokens)
        n, finished = 0, False
        for i in range(max_new_tokens):
            if n == 0 and cache_index == cfg.condition_length - 1:
                embeds = self.emb_text(torch.full(
                    (1, 1), cfg.audio_bos_token_id, device=dev))
            else:
                embeds = self.embed_code(audio_ids[:, max(n - 1, 0)][:, None])
            logits, cache = self.decode_step(embeds, cache, cache_index + n,
                                             text_mask)
            start = max(n - win, 0)
            window = audio_ids[0, start:start + win].T
            valid = (start + torch.arange(win, device=dev) < n).float()
            lg = self.filter_logits(logits, window, valid, n,
                                    min_new_tokens, temperature)
            if isinstance(draws, torch.Generator):
                gumbel = torch.empty(shape, device=draws.device).exponential_(
                    generator=draws).log_().neg_().to(dev)
            else:
                gumbel = draws[i].to(dev)
            next_ids = (lg + gumbel).argmax(-1)
            audio_ids[0, n] = next_ids
            finished = bool((next_ids == eos).any())
            if finished:
                break
            n += 1
        return audio_ids, cache, n, finished
