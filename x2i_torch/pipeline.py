"""X2I pipeline: MLLM hidden states -> proj -> FLUX -> VAE, the
counterpart of ``x2i_tpu/pipeline.py``: text2image, image2image,
imagetext2image, video2image, audio2image and x2image, the batched
``run_batch``, and LightControl's ControlNeXt branches in the denoise
(``with_controls``, ``generate(control_pixels=)``). ``lm_encoder`` joins a family's host half (templates,
tokens, image tiles or patches, log-mel chunks) and device half (vision
and audio towers and LM) into the encoder functions the pipeline calls.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no ``device="cpu"`` they raise.
They set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False, so that float32 products and
convolutions are float32 as in the JAX reference (the full-size path runs
in bf16, where the flags change nothing).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from x2i_torch.core.config import (ControlNeXtConfig, GenerationConfig,
                                   ProjConfig, SchedulerConfig, VAEConfig,
                                   tiny_flux_config, tiny_qwen2_config)
from x2i_torch.diffusion.sampling import (denoise_flux,
                                          prepare_latent_image_ids,
                                          unpack_latents)
from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
from x2i_torch.models.controlnext import ControlBank
from x2i_torch.models.decoding import (concat_answer_hiddens,
                                       greedy_decode_with_hiddens)
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.vae import AutoencoderKL, postprocess
from x2i_torch.params import random_init_


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Also fixes float32 matmuls and convolutions at full float32
    (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "x2i_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return device


def lm_encoder(prepare: Callable, forward: Callable,
               answer: Optional[Callable] = None):
    """-> (encoder_fn, encoder_batch_fn) from a family's host half
    (``prepare``) and device half (``forward``, ``answer``).

    prepare(request) -> (ids (S,) ints, mask (S,) bools, extra, whole):
    the host half of one request. ``extra`` is what the device half needs
    of it besides the tokens (its media as tiles or patch arrays, its
    positions), ``whole`` whether the prompt kept every media placeholder
    (False when the token budget cut some); every request of a batch
    gives the same S. forward(ids (B, S), mask (B, S), extras) -> the
    hidden-state stack: the device half, the batch's media in one vision
    call. answer(ids (1, S), mask (1, S), extra) -> the ``use_answer``
    stack of one request (the prompt's hidden states, then a decoded
    answer's); None: a ``use_answer`` request raises ValueError.

    A batch is encoded request by request, as in JAX, when it holds a
    ``use_answer`` request (the answer changes the stack's length) or a
    request that lost placeholders (the features fill the placeholders of
    the whole batch in order, so a cut row would shift every later
    row's)."""

    def encoder_batch_fn(requests: Sequence[Dict[str, Any]]):
        if any(r.get("use_answer") for r in requests) and answer is None:
            raise ValueError("use_answer: this encoder has no "
                             "answer-conditioned mode")
        preps = [prepare(r) for r in requests]
        if len(requests) > 1 and (
                any(r.get("use_answer") for r in requests)
                or not all(p[3] for p in preps)):
            return torch.cat([encoder_batch_fn([r]) for r in requests])
        ids = np.stack([p[0] for p in preps])
        mask = np.stack([p[1] for p in preps]).astype(bool)
        extras = [p[2] for p in preps]
        with torch.inference_mode():
            if requests[0].get("use_answer"):
                return answer(ids, mask, extras[0])
            return forward(ids, mask, extras)

    def encoder_fn(inputs: Dict[str, Any]):
        return encoder_batch_fn([inputs])

    return encoder_fn, encoder_batch_fn


# what a text-only encoder says of a request with media
MEDIA_REFUSED = ("this encoder takes text only: the port's media encoders "
                 "are those of the checkpoint families (images and video "
                 "for InternVL2.5 and Qwen2.5-VL, and audio for "
                 "MiniCPM-o), through convert/load.py")


def lm_text_encoder(lm: Qwen2LM, tokenize: Callable[[str], Tuple],
                    answer: Optional[Callable] = None):
    """``lm_encoder`` for text: tokenize(text) -> (ids (S,), mask (S,)),
    the LM at its default positions; answer(ids, mask) as
    ``lm_encoder``'s. A request with images, video or audio raises
    NotImplementedError."""
    dev = lm.embed_tokens.weight.device

    def prepare(r):
        if (r.get("images") or r.get("video") is not None
                or r.get("audio") is not None):
            raise NotImplementedError(MEDIA_REFUSED)
        return (*tokenize(r.get("prompt") or ""), None, True)

    def forward(ids, mask, extras):
        return lm(torch.as_tensor(ids, device=dev),
                  attention_mask=torch.as_tensor(mask, device=dev))[0]

    return lm_encoder(prepare, forward, None if answer is None else (
        lambda ids, mask, extra: answer(ids, mask)))


@dataclasses.dataclass
class X2IPipeline:
    """encoder_fn(inputs: dict) -> (B, C, S, H) LM hidden-state stack;
    encoder_batch_fn(list of dicts) -> the same for a batch, in one
    prefill; the other stages are modules on one device. ``load_report``
    is what a checkpoint loader read (``x2i_torch.convert.load``)."""

    encoder_fn: Callable[[Dict[str, Any]], torch.Tensor]
    proj: Proj
    flux: FluxTransformer2D
    vae: AutoencoderKL
    scheduler: FlowMatchEulerScheduler
    gen_cfg: GenerationConfig = GenerationConfig()
    encoder_batch_fn: Optional[Callable] = None
    load_report: Optional[Dict[str, Any]] = None
    # LightControl's branches (set by with_controls)
    control_bank: Optional[ControlBank] = None
    control_cfg: Optional[ControlNeXtConfig] = None
    # data-parallel serving (set by with_mesh): the mesh's data axis
    data_axis: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return next(self.flux.parameters()).device

    @torch.inference_mode()
    def encode(self, encoder_inputs: Dict[str, Any]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (pooled (B, 768), prompt_embeds (B, S, 4096))."""
        return self.proj(self.encoder_fn(encoder_inputs))

    @torch.inference_mode()
    def encode_batch(self, requests: Sequence[Dict[str, Any]]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One LM prefill for the whole request list when encoder_batch_fn
        is set, else one per request."""
        if self.encoder_batch_fn is not None:
            states = self.encoder_batch_fn(list(requests))
        else:
            states = torch.cat([self.encoder_fn(r) for r in requests])
        return self.proj(states)

    def with_controls(self, control_cfg: ControlNeXtConfig,
                      bank: ControlBank) -> "X2IPipeline":
        """A pipeline that also serves LightControl's ControlNeXt branches
        (instruction editing): ``generate(..., control_pixels=)`` adds
        their residuals to the double blocks at every step."""
        return dataclasses.replace(self, control_bank=bank,
                                   control_cfg=control_cfg)

    def with_mesh(self, mesh) -> "X2IPipeline":
        """Data-parallel serving over ``mesh`` (``core/mesh.py``), one
        process a rank: the DiT's, the VAE's and the bank's parameters are
        replicated (rank 0's broadcast to every rank, as JAX places them
        replicated; the encoder and the proj run whole on every rank) and
        ``generate`` splits each batch over the data axis, every rank
        drawing the whole batch's noise from the one seed and keeping its
        share, and returns the whole batch on every rank, as JAX returns
        the global array. Batches must be multiples of the data axis's
        size. Under ``ring_sequence`` the DiT's ring is the mesh's tensor
        axis (set on the shared DiT), and under ``shard_activations`` or
        ``shard_sequence`` its tensor axis: there each rank keeps only its
        member's shard of the split layers, cut after rank 0's broadcast
        (``FluxTransformer2D.set_tensor_axis``); the encoder, the proj and
        the VAE stay whole on every rank."""
        from x2i_torch.core.mesh import mesh_axis
        from x2i_torch.ops.quant import note_pre_scales_
        if torch.distributed.get_world_size() > 1:
            for mod in (self.flux, self.vae, self.control_bank):
                for t in ([] if mod is None else
                          [*mod.parameters(), *mod.buffers()]):
                    torch.distributed.broadcast(t.data, 0)
                # w4 layers read rank 0's pre_scale from here on
                if mod is not None:
                    note_pre_scales_(mod)
        data = mesh_axis(mesh, "data")
        if self.flux.cfg.ring_sequence:
            self.flux.set_ring_axis(mesh_axis(mesh, "tensor"))
        if self.flux.cfg.sharded:
            self.flux.set_tensor_axis(mesh_axis(mesh, "tensor"))
        return dataclasses.replace(self, data_axis=data)

    @torch.inference_mode()
    def _generate(self, noise: torch.Tensor, prompt_embeds: torch.Tensor,
                  pooled: torch.Tensor, height: int, width: int,
                  num_steps: int,
                  control_pixels: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """Packed noise (B, S_img, 64) -> pixels (B, H, W, 3) in [-1, 1]
        before postprocess: all steps' adaLN modulations, the Euler
        denoise (the control bank on ``control_pixels`` at every step),
        unpack, VAE decode (tiled above ``gen_cfg.vae_tile_px``, as in the
        JAX pipeline)."""
        dev, dt = self.device, self.flux.cfg.dtype
        img_ids = prepare_latent_image_ids(2 * (height // 16),
                                           2 * (width // 16), dev)
        txt_ids = torch.zeros((prompt_embeds.shape[1], 3),
                              dtype=torch.float32, device=dev)
        sigmas = self.scheduler.inference_sigmas(
            num_steps, image_seq_len=noise.shape[1], device=dev)
        gscale = (self.gen_cfg.guidance_scale
                  if self.flux.cfg.guidance_embeds else None)
        lat = denoise_flux(
            self.flux, noise.to(dev), prompt_embeds.to(dev, dt),
            pooled.to(dev, dt), sigmas, img_ids, txt_ids,
            guidance_scale=gscale,
            control_fn=None if control_pixels is None else self.control_bank,
            control_pixels=(None if control_pixels is None
                            else control_pixels.to(dev)))
        lat = unpack_latents(lat, height, width).permute(0, 2, 3, 1)
        tile_px = self.gen_cfg.vae_tile_px
        if tile_px and max(height, width) > tile_px:
            return self.vae.decode_tiled(lat)
        return self.vae.decode(lat)

    def generate(self, pooled: torch.Tensor, prompt_embeds: torch.Tensor,
                 height: Optional[int] = None, width: Optional[int] = None,
                 num_steps: Optional[int] = None, seed: Optional[int] = None,
                 control_pixels: Optional[torch.Tensor] = None
                 ) -> np.ndarray:
        """-> uint8 images (B, H, W, 3). The noise is drawn in bf16,
        whatever the DiT's dtype, as the JAX pipeline draws it, from a
        torch.Generator on the pipeline's device seeded with ``seed``; the
        latents keep that dtype through the Euler steps.
        control_pixels: (B, H, W, 3) guidance image in [-1, 1] for the
        ControlNeXt branches (needs ``with_controls``)."""
        if control_pixels is not None and self.control_bank is None:
            raise ValueError("control_pixels given but no ControlNeXt bank "
                             "attached; call with_controls() first")
        g = self.gen_cfg
        height, width = height or g.height, width or g.width
        num_steps = num_steps or g.num_inference_steps
        seed = g.seed if seed is None else seed
        s_img = (height // 16) * (width // 16)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randn((prompt_embeds.shape[0], s_img,
                             self.flux.cfg.in_channels), generator=gen,
                            device=self.device, dtype=torch.bfloat16)
        data = self.data_axis
        if data is None or data.size == 1:
            pixels = self._generate(noise, prompt_embeds, pooled, height,
                                    width, num_steps, control_pixels)
            return postprocess(pixels).cpu().numpy()
        if noise.shape[0] % data.size:
            raise ValueError(f"serving batch {noise.shape[0]} must be a "
                             f"multiple of the mesh data axis ({data.size})")
        from x2i_torch.core.mesh import take_share

        def mine(x):
            return None if x is None else take_share(x, data.rank, data.size)

        pixels = self._generate(mine(noise), mine(prompt_embeds),
                                mine(pooled), height, width, num_steps,
                                mine(control_pixels))
        images = postprocess(pixels)
        return data.gather([images], 0).cpu().numpy()

    def run_task(self, task: str, prompt: Optional[str] = None,
                 images: Optional[Sequence] = None,
                 video: Optional[Any] = None, audio: Optional[Any] = None,
                 use_answer: bool = False, **gen_kwargs) -> np.ndarray:
        """One request of ``task`` through the encoder, then one image.
        images: PIL images (or their host half's output, see the
        family's encoder); video: frames (``data/video.py``); audio: a
        16 kHz float waveform, which MiniCPM-o's encoder takes (the other
        families ignore it, as in JAX). ``use_answer``: condition
        on the prompt and a decoded answer (reasoning2image), where the
        encoder has that mode. ``gen_kwargs`` go to ``generate``
        (``control_pixels`` among them)."""
        inputs = {"prompt": prompt, "images": images, "video": video,
                  "audio": audio, "task": task, "use_answer": use_answer}
        pooled, prompt_embeds = self.encode(inputs)
        return self.generate(pooled, prompt_embeds, **gen_kwargs)

    def text2image(self, prompt: str, **kw) -> np.ndarray:
        return self.run_task("text2image", prompt=prompt, **kw)

    def image2image(self, images, **kw) -> np.ndarray:
        return self.run_task("image2image", images=images, **kw)

    def imagetext2image(self, prompt: str, images, **kw) -> np.ndarray:
        return self.run_task("imagetext2image", prompt=prompt,
                             images=images, **kw)

    def video2image(self, video, **kw) -> np.ndarray:
        return self.run_task("video2image", video=video, **kw)

    def audio2image(self, audio, **kw) -> np.ndarray:
        return self.run_task("audio2image", audio=audio, **kw)

    def x2image(self, prompt=None, images=None, audio=None,
                **kw) -> np.ndarray:
        return self.run_task("x2image", prompt=prompt, images=images,
                             audio=audio, **kw)

    def run_batch(self, requests, **gen_kwargs) -> np.ndarray:
        """One batched encode (one vision call and one LM prefill where
        the encoder batches) and one batched denoise for a list of
        ``run_task``-style request dicts (the serving engine's call)."""
        pooled, embeds = self.encode_batch(requests)
        return self.generate(pooled, embeds, **gen_kwargs)

    def serving_server(self, batch_size: int = 1, max_wait_s: float = 0.05,
                       buckets=None, **gen_kwargs):
        """-> x2i_torch.serve.BatchingServer over this pipeline."""
        from x2i_torch.serve import BatchingServer
        return BatchingServer(
            lambda reqs: self.run_batch(reqs, **gen_kwargs),
            batch_size=batch_size, max_wait_s=max_wait_s, buckets=buckets)


def tiny_vae_config(**overrides) -> VAEConfig:
    base = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
                latent_channels=16, norm_num_groups=4)
    base.update(overrides)
    return VAEConfig(**base)


def build_random_pipeline(scale: str = "tiny", seed: int = 0,
                          gen_cfg: Optional[GenerationConfig] = None,
                          device=None, dtype=torch.bfloat16
                          ) -> X2IPipeline:
    """Random-weight tiny pipeline for smoke runs without checkpoints,
    mirroring the JAX ``build_random_pipeline("tiny")``: a tiny Qwen2 over
    per-character token ids (crc32, stable across processes), padded to 32
    tokens and all attended, as the JAX tiny encoder does; ``use_answer``
    decodes 8 tokens (EOS id 1). ``pipe._random_ctx`` holds the LM, its
    config and the tokenizer, for ``multiturn.build_random_session``."""
    if scale != "tiny":
        raise NotImplementedError("full-scale weights need checkpoints")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flux_cfg = tiny_flux_config(dtype=dtype, attention_impl="auto")
    lm_cfg = tiny_qwen2_config(dtype=dtype, attention_impl="auto")
    proj_cfg = ProjConfig(in_channels=lm_cfg.num_layers_with_embedding,
                          input_dim=lm_cfg.hidden_size,
                          output_dim0=flux_cfg.pooled_projection_dim,
                          output_dim1=flux_cfg.joint_attention_dim,
                          dtype=dtype)
    seq = 32

    def tokenize(text: str):
        ids = np.zeros(seq, np.int64)
        toks = [zlib.crc32(c.encode()) % lm_cfg.vocab_size
                for c in (text or "")][:seq]
        ids[:len(toks)] = toks
        return ids, np.ones(seq, bool)

    lm = random_init_(Qwen2LM(lm_cfg, dev), gen)

    def answer(ids, mask):
        ids, mask = torch.as_tensor(ids, device=dev), torch.as_tensor(
            mask, device=dev)
        prefill, steps, _, _ = greedy_decode_with_hiddens(
            lm, lm.embed(ids), mask, max_new_tokens=8, eos_token_id=1)
        return concat_answer_hiddens(prefill, steps)

    encoder_fn, encoder_batch_fn = lm_text_encoder(lm, tokenize,
                                                   answer=answer)
    pipe = X2IPipeline(
        encoder_fn=encoder_fn,
        proj=random_init_(Proj(proj_cfg, dev), gen),
        flux=random_init_(FluxTransformer2D(flux_cfg, dev), gen),
        vae=random_init_(AutoencoderKL(tiny_vae_config(dtype=dtype), dev),
                         gen),
        scheduler=FlowMatchEulerScheduler(SchedulerConfig(shift=1.0)),
        gen_cfg=gen_cfg or GenerationConfig(height=64, width=64,
                                            num_inference_steps=4),
        encoder_batch_fn=encoder_batch_fn)
    # not a dataclass field: checkpoint pipelines have no such handle
    pipe._random_ctx = {"lm": lm, "lm_cfg": lm_cfg, "tokenize": tokenize}
    return pipe
