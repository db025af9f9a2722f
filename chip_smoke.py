#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (x2i_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases, each printing one JSON line per record:

1. build: compile the CUDA sources (csrc/flash_fwd.cu,
   csrc/flash_chunked.cu, csrc/flash_bwd.cu, csrc/int8_gemm.cu and
   csrc/row_glue.cu, one nvcc each, started together) from the sources
   in this checkout; print what ptxas said of every kernel (registers,
   spills, serialized wgmma) and fail on a spill, a serialized wgmma
   pipeline, an ignored setmaxnreg or a kernel missing from the log in
   any of the five libraries (``cuda_lib.build_faults``);
2. kernels: hold each kernel against its plain PyTorch version at the main
   path's shapes, on rows whose scale spans decades, and time kernel,
   plain version and, as a yardstick, the one PyTorch call that computes
   the same function (device time, see ``kernel_ms``), the K1 records
   with their TFLOP/s and share of the bound, their grid instance, blocks
   an SM (CUDA's occupancy calculator, held to what the instance is built
   for) and waves, K1b's with the host time of one call; K5-K8 with
   their share of the bound, K8 bit for bit against the plain
   quantization at every width of the w8a8 path and on tie rows, K6 bit
   for bit K8 after K5; the attention
   backward (K1 with its lse, K3, K4) at the distillation step's shapes;
   the chunked forward K2 at the 2048^2 DiT's and the 32k-token LM's
   shapes, also against the plain f32 attention; the f32 instances of K1
   with the lse, K3 and K4 at the f32 phase-2 step's shape and of K2 at
   the f32 2048^2 DiT's, each against its f32 plain version beside the
   bf16 instance on the same inputs rounded to bf16 (no farther from it
   in relative L2), timed beside SDPA in f32; head dim 256 (the 12 x 256
   DiT's shapes): K1a at (1, 12, 4608, 256), K1's masked body with the
   rope on the 960^2 pad route (4112 of 4224 keys) and K2 at (1, 12,
   16896, 256), beside SDPA at D = 256; under autograd at D = 256 K1 with
   the lse, K3 and K4 at the phase-2 shape (1, 12, 4608, 256) with the
   rope outside and inside, on the pad route, at a ring shard (1, 12,
   1152, 256) and in f32, and K2 with the lse (bf16 and f32) at a ring
   of 2's pair (1, 12, 8448, 256), beside SDPA's forward and backward;
   the f32 DiT's fused glue: K1's
   f32 rope-and-norm instance at (1, 24, 4608, 128) (its o rounded to
   bf16 against the bf16 K1a's on the rounded inputs) beside SDPA in f32,
   and K5's f32 instance at the DiT's three row counts and at 4608 rows x
   4096 and 6144 beside F.layer_norm in f32; the f32 w8a8 and w4a8 DiT's:
   K8 on f32 rows bit for bit at every width of the path and on tie rows, K6
   and K7 on f32 rows (codes within one step, at most 0.1% flipped,
   scales within 1e-5), also at the 32 x 128 DiT's 4096 and 16384, the
   int8 and w4a8 GEMMs' f32 epilogue bit for bit at the DiT's twelve
   shapes (timed beside the bf16 epilogue), the f32 int8 and w4
   dequantize kernels bit for bit at the DiT's weights; the int8 GEMM at the
   w8a8 DiT's twelve shapes; the w4a8 GEMM at the same twelve, the LM's and
   two more chunks (its int32 sum exact and its output bit for bit, timed
   beside the int8 GEMM on its materialized operand and the bf16 product);
   the w4 dequantize kernel bit for bit at the DiT's weight shapes; the
   dequantizing GEMM of w4 (groups of 128 and 64) and w8 at the DiT's
   weights, one and four rows, with and without bias: its converted weight
   bit for bit the dequantize kernels', its output within two bf16
   roundings of the plain version's, timed beside cuBLAS on the
   materialized weight; K1b also at the registry's larger LMs (16 q on 2 kv
   heads and 28 on 4, D = 128, 40 and 400 valid keys) and K2 at the 7B
   LMs' 32k prefill (28 on 4 heads x 128); the int8 GEMM at the int8 7B
   LM's products at one decode row and at the 512-token prefill, and K8
   at its decode rows (3584 and 18944 wide); K1b at InternViT-300M's
   shape (16 heads x 64, 1025 tokens padded to 1152, 127 masked keys,
   non-causal; beside it the same heads at 1024 rows, 127 masked keys,
   which fit one wave of 128-row blocks), at the CLIP ViT-L/14's (4
   images, 16 heads x 64, 257 tokens padded to 384; also K1's f32
   instance there, f32 in and out, within the bf16 bars of the f32 plain
   version) and at MiniCPM-o's
   resampler's (28 heads x 128, 64 query rows padded to 128, one slice
   of 1024 patches and a batch of slices of 1024 and 600), SDPA on the
   same padded, masked tensors beside each; the straight-through
   backward's int8 and w4a8 dequantize kernels bit for bit at the DiT's
   weight shapes; one QuantLinear's straight-through dx on the card in
   each of w8a8, w8, w4 and w4a8 against the same layer's on the CPU;
2a. checkpoint: a released-layout checkpoint set of x2i-internvl2.5-1b
   at full width (diffusers FLUX, its DiT cut to 1 double + 2 single
   blocks in two shards, the whole VAE; an InternVL directory with
   InternViT-300M, mlp1 and the Qwen2.5-0.5B LM; the proj's .bin),
   written to a temporary directory and loaded by
   ``build_pipeline_from_checkpoints`` onto the card, with its time,
   rate, host and card peak memory; loaded on the CPU too, and the two
   copies held equal bit for bit (nothing of the directory unread, the
   VAE's encoder among it), the VAE's encode on the card against the CPU
   copy's (``check_vae_encode``); one
   1024^2 imagetext2image with exact launch counts, and the same image
   after a load in the default w8; then a MiniCPM-o-2.6 directory
   (SigLIP-so400m with its 27 blocks, the resampler, Whisper-medium and
   the audio projector at full width, the Qwen2-7B LM cut to 2 layers,
   a TTS tensor) beside the same cut DiT, loaded onto the card and the
   CPU and held equal bit for bit, unread only what JAX leaves unread,
   and its x2image (prompt, image, 5 s of audio) with exact launch
   counts; then cli (``phase_cli``): the port's entry points in this
   process, ``convert.load.mllm_tokenizer`` giving ``ByteTokenizer`` (the
   one seam): ``python -m x2i_torch.cli`` text2image at 1024^2 (a prompt
   of ``prompts.TEXT2IMAGE_MULTILINGUAL``) in w8 and w8a8 with exact
   launch counts, the w8 PNG's bytes those of the same writer over
   ``run_task``'s image, audio2image on the MiniCPM-o set from a 5 s WAV,
   ``multiturn`` (two turns of 8 answer tokens, then ``stop``);
   ``python -m x2i_torch.convert.cli`` flux --quantize w8a8, vae, mllm
   and proj, each saved state bit for bit the loader's module; the
   ComfyUI nodes (``MLLMLoader``, ``ProjLoader`` on an npz of the
   pipeline's proj, ``MLLMEncode``), the conditioning bit for bit
   ``pipe.encode`` with 24 K1b launches; then assemble:
   ``assemble_distill`` on the card from the
   x2i-internvl2.5-1b set with a T5-XXL encoder directory at full width
   cut to 2 blocks and a whole CLIP-L text directory (every tensor read
   bit for bit the one written, nothing unread), 2 ``TrainLoop`` steps
   from caption shards with the launch counts derived for the cut DiT;
3. text2image: the full-width random-weight x2i-internvl2.5-1b pipeline
   (Qwen2.5-0.5B LM, internvl1b proj, FLUX.1-schnell DiT, FLUX VAE, bf16)
   makes a 1024x1024 image in 4 steps; launch counts prove the route; a
   2+2-block full-width DiT holds the kernel route against the plain one;
3i. interleaved: the same DiT's q/k channels and qk-norm scales permuted
   in place back to the checkpoints' interleaved rope layout
   (``set_rope_layout_``): the same image with the qk norm and the
   rotation before a no-rope kernel (K1c 228, K1a 0, K5 460), within 2e-2
   relative L2 of the half layout's pixels; permuted back bit for bit; a
   2+2-block interleaved DiT holds its kernel route against the plain
   one;
3p. proj-variants: at the internvl1b proj's widths over the LM's
   512-token stack, ``Proj(use_t5=True)`` (2 T5 layers, plain attention
   under the relative bias: no launch) makes the 1024^2 image with the
   text image's counts; ``TransformerProj`` in f32 (3 launches of K1's
   f32 instance a call) against its plain route; ``LegacyProj`` "proj3"
   in f32, timed;
4. serve: a BatchingServer over the same pipeline answers 3 concurrent
   requests at 512x512;
4i. image: InternViT-300M and mlp1 drawn on the card beside the same
   LM, proj, DiT and VAE: one image2image and one imagetext2image at
   1024^2 (one 448 tile, 256 <IMG_CONTEXT> tokens) with exact launch
   counts (K1b 24 in the ViT and 24 in the LM, K1a 228, K5 460), the
   ViT's ms, the host half's ms and route (PIL, or the host half's
   arrays drawn from the seed where PIL is missing); the encoder's stack
   on the kernel route against the plain attention; two image requests
   through the batch path (one ViT call) against two serial encodes,
   then one run_batch of both;
4a. text2image-2048: the same pipeline makes a 2048x2048 image (16,896
   joint tokens: every DiT attention is K2, norm and rope outside it; the
   VAE decodes 6 x 6 tiles), with exact launch counts; a 2+2-block
   full-width DiT holds the kernel route against the plain one at 9,728
   tokens;
4b. long-prompt: a 32,768-token prompt (30,000 valid) through
   ``Qwen2LM.encode_premixed`` and ``Proj.mlp`` on the same LM and proj
   (24 K2 launches, no K1); the streamed encode held against the stack
   route at 8,448 tokens;
4c. d256: a 12 heads x 256 DiT (FLUX's width and depth, heads regrouped)
   on the same DiT's linear weights (new qk-norm scales only): 1024^2
   (K1a at D = 256, 228), 2048^2 (K2 at D = 256, 228) and 960^2 (4112
   tokens, the pad route: K1's masked body with the rope at D = 256, 228)
   images through ``X2IPipeline.text2image`` with exact launch counts,
   each with a 2+2-block route check at D = 256; d256-train: the phase-2
   step on that DiT (bf16, 32-bit AdamW, one warm-up and two timed steps:
   K1c 1, K1-lse 112, K3 56, K4 56 a step at D = 256, no plain attention
   at D = 256); d256-ring: the same DiT under ``ring_sequence`` on a ring
   of 4 at 1024^2 and 2048^2 (K1-lse 3648 an image at (1, 12, 1152, 256)
   and (1, 12, 4224, 256)) against the unsharded d256 / d256-2048
   images;
4d. f32: the same DiT cast in place to f32, its glue unfused: f32-2048,
   one 2048^2 4-step text2image (warmed up by one f32 DiT step) with
   exact launch counts (K2's f32 instance 228, the LM's K1b 24), no plain
   attention in the DiT, its peak memory and its distance from the bf16
   2048^2 image; lightcontrol-train-f32, the phase-2 step on it (the bank
   in f32, 32-bit AdamW, one warm-up and one timed step: K1's f32 forward
   1, its lse instance 112, K3's 56, K4's 56 a step; the bank moved, the
   DiT unchanged); lightcontrol-train-f32-d256, the same step on the
   12 x 256 DiT in f32 (the f32 instances' counts at D = 256); f32-fused:
   a 1024^2 f32 image unfused, then with
   ``fused_glue=True`` (K1's f32 rope-and-norm instance 228 in both, K5's
   f32 instance 460 in the fused one), the two within 2e-2 relative L2;
   the DiT cast back to bf16, bit for bit the one before; the 2+2-block
   route checks in f32 (the image's at 1536^2, the fused glue's at 512^2,
   the phase-2 gradient's), and on a DiT of 32 heads x 128 (width 4096)
   in f32 unquantized and in w8a8 with the glue fused (K5 f32 at 4096;
   K6, K7 and K8 f32 at 4096, 16384 and 4096);
5. distill: the full-width phase-1 distillation trainer on the same bf16
   DiT and LM (no second copy), with T5-XXL's encoder and CLIP-L's text
   tower drawn on the card: one warm-up step and three timed steps, each
   teacher then student, with exact launch counts per step; a 2+2-block
   full-width DiT holds the conditioning gradient of the kernel route
   (K1 with the lse, K3, K4) against the plain attention's;
5p. parallel: the parallel layer in its one-process form (one process
   holds every member of an axis; the process form is
   tests/test_torch_parallel_ranks.py: gloo on the CPU, NCCL on a
   machine with four cards). On the distillation
   trainer, before it is freed: two steps through ``TrainLoop`` on
   ``make_mesh()`` (the 1 x 1 x 1 mesh over NCCL) bit for bit two without
   a mesh, and the disaggregated pools on cuda:0 (the first loss against
   the colocated step's within rtol 1e-4, then three steps from
   ``train_stream``). Then ring-kernels: the ring of 4 at (1, 24, 4608,
   128) against K1 with the lse and K3/K4 on the whole sequence, and at
   2048^2 rings of 4 (K1 with the lse) and 2 (K2 with the lse) against K2,
   the ring of 4 at 4608 tokens in f32 (the f32 instances), and at
   D = 256 a ring of 4 at 4608 tokens and a ring of 2 at 16,896 (K2 with
   the lse, K3 and K4 on 8448-token pairs) forward and backward, exact
   launch counts, each ring's time beside the whole kernel's;
   ring-image: a 2048^2 image under ``ring_sequence`` on a ring of 4
   (3648 K1-lse launches) against a ring of one; pipeline-forward: the
   DiT at 1024^2, batch 2, through ``flux_pipeline_forward`` on 4 stages
   against the plain forward; mesh serving: ``with_mesh`` generate at
   512^2, batch 2, bit for bit the plain one;
5d. data-train: the same trainer fed from two caption-only tar shards
   (no PIL on the card's machine): one warm-up and six steps through
   ``DistillDataModule.train_loader`` (the native tar reader, which must
   load; ``PrefetchLoader`` with the side-stream copy, each batch on the
   card bit for bit its numpy batch; the consumer's wait and the loader
   thread's ms a batch), two from a ``RemoteFetchLoader`` whose worker
   is a spawned child on 127.0.0.1, and its rate on 16 samples; exact
   launch counts; the steps inside ``frozen_heap``, as ``TrainLoop.run``
   takes them, with each step's garbage-collection seconds;
5e. eval: 2 prompts x 2 seeds at 512^2 through ``seed_matched_protocol``
   on the bf16 pipeline, resized on the card, scored by a CLIP ViT-L/14
   and CLIP-L text tower drawn from the seed, in bf16 (K1b 24 times a
   call, the pad route) and f32 (K1's f32 instance 24 times a call, the
   same route): features within cosine 0.99, CLIP-T within 0.3 points,
   the Frechet distance of the two seeds' features; ``image_features``
   ms;
5a. lightcontrol: LightControl's 19 ControlNeXt branches (ControlNeXtConfig
   at its defaults, drawn on the card) attached to the same bf16
   pipeline; a 1024^2 text2image with a 1024^2 guidance image, its launch
   counts the text image's (the bank's convolutions and GroupNorms are
   cuDNN and PyTorch's), the bank's device time a step beside its bound;
   with the bank's out convs zeroed the image is bit for bit the one
   without controls; a 2+2-block route check with the bank's controls;
5b. lightcontrol-train: the phase-2 step at full width and depth on the
   same DiT (the trainer's config, set back after), VAE, LM and proj,
   InternViT drawn again for an imagetext2image conditioning: one warm-up
   and three timed steps, each split into the VAE encode, the
   conditioning, the bank and the DiT, and the optimizer; exact launch
   counts per step, the bank moved, the DiT bit for bit unchanged; a
   2+2-block full-width DiT holds the controls' gradient of the kernel
   route (K1c, K1 with the lse, K3, K4) against the plain attention's;
5c. train-resume: the same DiT quantized in place to w8a8
   (``quantize_module_``) and trained at JAX's single-chip phase-1
   operating point (inline KD, int8 teacher stacks, 8-bit AdamW) through
   ``TrainLoop`` with checkpoints every 2 steps: run A 4 steps unbroken
   (exact launch counts per step: the int8 GEMM and K8 forward, the int8
   dequantize kernel's straight-through backward), run B 2 steps, then a
   new loop that resumes at step 2 and runs to 4, its proj and 8-bit
   state bit for bit run A's; the 2+2-block w8a8 gradient route check;
   the phase-2 step with 8-bit AdamW on the w8a8 DiT
   (``lightcontrol-train-w8a8``: its optimizer's s); the training command
   line (``python -m x2i_torch.train.cli``) on the card: ``distill``
   for 4 steps, again to 6 resuming at 4, and ``lightcontrol``;
6. w8a8: the same w8a8 DiT (set back to its serving config) makes the
   same image through the quantizing glue kernels and the int8 GEMM, with
   exact launch counts, and its pixels are compared with the bf16 ones; a
   2+2-block full-width w8a8 DiT holds the kernel route against the plain
   route (unfused glue, plain quantization and product, plain attention)
   on the same int8 weights; then the same image with the bank
   (``lightcontrol-w8a8``), with the same counts; then f32-w8a8: the same
   DiT cast in place to f32 (its layers' dtype too; the codes and scales
   stay), the 1024^2 image unfused, then with the glue fused once as the
   warm-up and once timed (K6, K7, K8 on f32 rows, the int8 GEMM's f32
   epilogue: 460 / 304 / 412 / 1936 launches), within 2e-2 relative L2 of
   the unfused f32 image, its distance from the bf16 w8a8 image, then
   cast back bit for bit, and its 2+2-block f32 route check;
7. w4a8 and w4: the bf16 DiT drawn again from the generator state it was
   drawn from (the same weights), quantized in place to w4a8 and makes
   the same image through K6/K7/K8 and the w4a8 GEMM; then drawn again
   and quantized to w4, the same image through K5 and the dequantizing
   GEMM; each with exact launch counts, its pixels compared with the bf16
   ones, and a 2+2-block full-width DiT in the mode holding the kernel
   route against the plain route on the same int4 weights; then w8 the
   same way (K5 and the dequantizing GEMM); in w4a8 also f32-w4a8 as
   f32-w8a8 (the w4a8 GEMM's f32 epilogue), in w4 and w8 the 2+2-block
   f32 route check (K5 f32, the f32 dequantize kernel before F.linear);
   after the w4a8 and the w4 images, a phase-2 step with 8-bit AdamW on that DiT
   (``lightcontrol-train-w4a8``: the w4a8 GEMM and K8 forward, the w4a8
   dequantize kernel's straight-through backward;
   ``lightcontrol-train-w4``: the dequantizing GEMM forward, the w4
   dequantize kernel's backward; exact counts);
8. registry: the five other MODEL_REGISTRY entries at full width and
   depth (LMs of 36 x 2048 and 28 x 3584, the FLUX.1-dev entry in 28
   steps with guidance and dynamic shifting), one 1024^2 image each
   through the family's template and positions, with exact launch
   counts; then, on their vision towers drawn on the card, the
   x2i-internvl2.5-4b entry's imagetext2image, each Qwen2.5-VL entry's
   image2image (its tower takes the plain route: no launch), and the
   7B's video2image (eight 128^2 frames) and a use_answer image after an
   image input; x2i-minicpm-o-2.6's image2image, audio2image (5 s of
   audio), x2image and video2image (4 frames) on SigLIP, the resampler,
   Whisper and the projector drawn on the card (K1b 29 / 28 / 29 / 29:
   the LM's 28 and the resampler's one call), its stack on the kernel
   route held against the plain attention, and a batch of an image and
   an audio request (one SigLIP and one Whisper call, the stacks against
   the serial ones); on the x2i-qwenvl2.5-7b entry, before its LM is freed:
8a. answer: use_answer reasoning2image on that LM (bf16): the 512-token
   prompt's cached prefill, 128 greedy steps, a 640-token conditioning,
   one 1024^2 image with exact launch counts (no K1b: the cache takes the
   plain attention); the decode's ms per token beside its bound, the
   host's enqueue time of a step against its device time (the step
   replayed from a CUDA graph),
   and the decode held against the cache-less forward (K1b) over the same
   tokens;
8b. chat: a two-turn MultiTurnSession (32 tokens and an image a turn) and
   a StreamingSession (three chunks, then 64 tokens, held against the
   cache-less forward) on the same LM;
8t. tts: MiniCPM-o's speech half at full width (the 20-layer ChatTTS GPT,
   the DVAE and the Vocos vocoder in f32, drawn from the seed) speaks a
   sentence through ``TTSPipeline.speak`` (256 audio tokens), conditioned
   on the streamed reply's last hidden state; ms per audio token, a step's
   host enqueue against its device time, the stages' ms, the real-time
   factor, the speech's share of a streamed turn, and the card against a
   CPU float32 run of the same weights and codes (logits, the
   teacher-forced cache, the waveform);
8c. answer-w8a8: the same LM quantized in place to w8a8 and the same
   request through the int8 GEMM and K8 at one row and at 512 rows, exact
   launch counts, its decode's cost and bound and its conditioning's
   distance from the bf16 one; a 2-layer full-width int8 LM holds its
   kernel route against the plain route.

Then a "kernels" line, the card's name and power limit from nvidia-smi,
and as the last line {"ok": true, "device": {...}}. Any failure raises,
so the exit code is not 0 and the last line is never printed. Needs CUDA:
without a CUDA device it exits with code 2 and prints no result. To check
the kernels alone after an edit, run the tests marked ``cuda``
(``pytest --noconftest tests/test_torch_kernels.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, f32
# outside the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FLASH_SRC = "x2i_torch/csrc/flash_fwd.cu"
FLASH_CHUNKED_SRC = "x2i_torch/csrc/flash_chunked.cu"
FLASH_BWD_SRC = "x2i_torch/csrc/flash_bwd.cu"
GEMM_SRC = "x2i_torch/csrc/int8_gemm.cu"   # also the int4 kernels
ROW_GLUE_SRC = "x2i_torch/csrc/row_glue.cu"
TPU_FLASH = "x2i_tpu/ops/flash_attention.py"
TPU_GLUE = "x2i_tpu/ops/fused_glue.py"


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's record also says when it was printed, in
    seconds since the script started (``at_s``)."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


# more than twice the H100's 50 MB L2 cache
L2_SWEEP_BYTES = 128 << 20


def call_ms(fn, iters: int = 10) -> float:
    """Median of `iters` warm calls, each between one pair of CUDA events:
    a layer's latency as its caller sees it, host launch path included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_CYCLES_PER_MS = []


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms, measured once."""
    import torch
    if not _CYCLES_PER_MS:
        cycles = 1 << 24
        _CYCLES_PER_MS.append(cycles / call_ms(
            lambda: torch.cuda._sleep(cycles), iters=3))
    return _CYCLES_PER_MS[0]


def kernel_ms(fn, *inputs, iters: int = 10) -> float:
    """The card's time for one call of fn(*inputs), in ms.

    The median over `iters` groups of back-to-back calls, each group
    between one pair of CUDA events and divided by its length. A sleep
    kernel queued ahead of each group holds the card while the host queues
    the group, so the events time the card and not the host's launch path;
    a group the host had not queued in full when the sleep ended is timed
    again, half as long after a sleep twice as long. The calls cycle
    through up to 32 copies of the tensor `inputs`, together larger than
    the L2 cache where the inputs are over 4 MB, so that each call reads
    its inputs from memory, as it does on the main path."""
    import torch
    copies = min(32, -(-L2_SWEEP_BYTES // nbytes(*inputs)))
    pool = [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(copies - 1)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn(*inputs)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    # at least 2 ms of work, and every copy once
    n = max(len(pool), min(200, math.ceil(2.0 / start.elapsed_time(end))))
    sleep_ms = 2.0 * n * host_ms + 1.0
    times = []
    while len(times) < iters:
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
        start.record()
        for i in range(n):
            fn(*pool[i % len(pool)])
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            times.append(start.elapsed_time(end) / n)
        elif sleep_ms > 10_000:
            raise RuntimeError("kernel_ms: the host cannot queue the calls "
                               "ahead of the card")
        else:
            sleep_ms, n = 2 * sleep_ms, max(1, n // 2)
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """Least time on the card (ms) and what sets it, for `flops`
    operations at the peak rate `peak` of their type."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# ---------------------------------------------------------------- build

def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from x2i_torch.ops.cuda_lib import build_faults, ptxas_report

    t0 = time.perf_counter()
    libs = _cuda_libraries()
    with ThreadPoolExecutor(len(libs)) as pool:
        builds = [pool.submit(lambda lib=lib: (lib.lib(),
                                               time.perf_counter() - t0))
                  for lib in libs]
        nvcc_s = [f.result()[1] for f in builds]
    # per library and kernel: registers, spill bytes, serialized wgmma
    ptxas = {lib.src.name: ptxas_report(lib.build_log) for lib in libs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": dict(zip([lib.src.name for lib in libs], nvcc_s)),
          "libraries": [lib.library_path().name for lib in libs],
          "ptxas": ptxas})
    # every library: a spill, a serialized wgmma pipeline or an ignored
    # setmaxnreg leaves a kernel right but several times slower with no
    # other sign
    for lib in libs:
        if faults := build_faults(lib.build_log, lib.gated_kernels):
            raise AssertionError(f"{lib.src.name}: {faults}")


# -------------------------------------------------------------- kernels

def _rope_tables(s_txt, grid, axes, device):
    import torch
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.ops.rope import flux_rope_freqs_half
    ids = torch.cat([torch.zeros((s_txt, 3), device=device),
                     prepare_latent_image_ids(grid, grid, device)])
    return flux_rope_freqs_half(ids, axes)


def _pairs(qt, kt, kw) -> int:
    """The (query, key) pairs this run's data needs, over all q heads:
    every pair, or with a mask or causal the valid keys at or below the
    diagonal."""
    import torch
    b, hq, sq, _ = qt.shape
    skv = kt.shape[2]
    mask = kw.get("kv_mask")
    if mask is None and not kw.get("causal"):
        return b * hq * sq * skv
    valid = (torch.ones((b, skv), dtype=torch.bool, device=qt.device)
             if mask is None else mask)
    per_row = valid.int().cumsum(-1)[:, :sq] if kw.get("causal") else \
        valid.int().sum(-1, keepdim=True).expand(b, sq)
    return per_row.sum().item() * hq


def _tables(kw):
    tables = []
    if kw.get("rope") is not None:
        tables += list(kw["rope"])
    if kw.get("qk_norm") is not None:
        tables += [w for w in kw["qk_norm"][:2]]
    return tables


def _flash_bytes(qt, kt, vt, out, kw, valid_rows=None) -> int:
    """The bytes one attention call must move: the q and output rows the
    caller keeps (`valid_rows` of each (batch, head), by default all),
    the k and v rows the mask keeps, the mask and the tables."""
    b, _, sq, _ = qt.shape
    keep = (valid_rows or sq) / sq
    mask = kw.get("kv_mask")
    keys = (kt.shape[0] * kt.shape[2] if mask is None
            else int(mask.sum()))
    kv_row = kt.shape[1] * (kt.shape[-1] * kt.element_size()
                            + vt.shape[-1] * vt.element_size())
    return int(keep * nbytes(qt, out)) + keys * kv_row + nbytes(
        mask, *_tables(kw))


def rate(rec, flops):
    """Adds the achieved TFLOP/s and the share of the bound to a record
    that has its time and its bound."""
    rec["tflops"] = flops / rec["ms"] / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def k1_grid(q_shape, f32: bool = False) -> dict:
    """K1's grid for (B, H, S, D) q on this card: the instance
    (``fwd_instance``: consumer warpgroups, the blocks an SM it is built
    for; the f32 instances take 128-row blocks, one an SM), its blocks, the
    blocks one SM holds at once by CUDA's occupancy calculator, and the
    waves. Fails where the card holds fewer blocks than the instance is
    built for."""
    import torch
    from x2i_torch.ops import flash_attention as fa
    b, hq, sq, d = q_shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wgs, per_sm = (2, 1) if f32 else fa.fwd_instance(b, hq, sq, d, sms)
    blocks = b * hq * sq // (64 * wgs)
    resident = fa.fwd_blocks_per_sm(d, wgs, per_sm)
    if resident != per_sm:
        raise AssertionError(f"K1's instance {(d, wgs, per_sm)} is built for "
                             f"{per_sm} blocks an SM; the card holds "
                             f"{resident}")
    return {"instance": [wgs, per_sm], "blocks": blocks,
            "blocks_per_sm": resident,
            "waves": math.ceil(blocks / (resident * sms))}


def dkv_d256(k_shape, q_heads, q_rows, rope: bool, masked: bool,
             f32: bool, reduce_launches: int):
    """What a K4 record at head dim 256 carries of the instance that ran:
    its design (warpgroups by role), the registers ptxas gave it (from the
    library's build log; ``flash_bwd_dkv_roles_kernel`` <ROPE, MASKED,
    OutT>), its split (``dkv_splits`` of its 64-row blocks of (B, Hk, Skv,
    D) keys on this card) and the reduce kernel's launches in one call,
    which a split's alone has (``reduce_as_split``)."""
    import torch
    from x2i_torch.ops import cuda_lib
    from x2i_torch.ops import flash_attention as fa
    name = (f"flash_bwd_dkv_roles_kernelILb{int(rope)}ELb{int(masked)}E"
            f"{'f' if f32 else '13__nv_bfloat16'}E")
    regs = [r["registers"] for k, r in cuda_lib.ptxas_report(
        fa.KERNEL_BWD.build_log).items() if name in k]
    b, hk, skv, _ = k_shape
    splits = fa.dkv_splits(b * hk * skv // 64, q_heads // hk * q_rows // 64,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    return {"design": "warpgroups by role: s, p and dv; dp, ds and dk",
            "instance": name, "registers": regs[0] if regs else None,
            "splits": splits, "reduce_launches": reduce_launches,
            "reduce_as_split": reduce_launches == int(fa.dkv_reduces(splits))}


def check_flash(name, q, k, v, records, tol_max=1e-2, tol_mean=1e-3,
                library=None, host_time=False, valid_rows=None, **kw):
    """q (B, S, H, D) etc. are passed as (B, H, S, D) views, as the
    dispatcher passes them on the main path. `library` is (fn, inputs),
    the one PyTorch call timed as a yardstick. `host_time` adds
    ``call_ms``, one call as its caller sees it, host path included: a
    launch-bound kernel's row is then told from a slow kernel's.
    `valid_rows`: the q rows the caller keeps (the pad route slices off
    the others), which the bound counts; by default all. The bound's
    bytes count those rows of q and the output and the k and v rows the
    mask keeps."""
    import torch
    from x2i_torch.ops import flash_attention as fa
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = fa.flash_attention(qt, kt, vt, **kw)
    want = fa.flash_attention_plain(qt, kt, vt, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err_max, err_mean = diff.max().item(), diff.mean().item()
    finite = bool(torch.isfinite(got).all())
    ms = kernel_ms(lambda *t: fa.flash_attention(*t, **kw), qt, kt, vt)
    plain_ms = kernel_ms(lambda *t: fa.flash_attention_plain(*t, **kw),
                         qt, kt, vt)
    lib_ms = kernel_ms(library[0], *library[1]) if library else None
    flops = 4.0 * _pairs(qt, kt, kw) * qt.shape[-1] * (
        (valid_rows or qt.shape[2]) / qt.shape[2])
    bms, by = bound(flops, _flash_bytes(qt, kt, vt, got, kw, valid_rows))
    rec = {"phase": "kernels", "kernel": name, "shape": list(qt.shape),
           "kv_shape": list(kt.shape), "max_abs_err": err_max,
           "mean_abs_err": err_mean, "finite": finite, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
           "bound_by": by,
           **k1_grid(qt.shape, qt.dtype == torch.float32)}
    rate(rec, flops)
    if host_time:
        rec["call_ms"] = call_ms(
            lambda: fa.flash_attention(qt, kt, vt, **kw), iters=50)
    emit(rec)
    if not (finite and err_max <= tol_max and err_mean <= tol_mean):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {rec}")
    records.append(rec)


def _rel_errors(got, want):
    """(max, mean) absolute error relative to the largest |want|."""
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    return diff.max().item() / top, diff.mean().item() / top


def check_flash_train(label, q, k, v, do, records, library, **kw):
    """The distillation step's attention at one shape: K1 with the lse
    against its plain version (o within 1e-2 max and 1e-3 mean absolute
    error, the lse within 1e-3 in log2 units), and K3 and K4 against
    theirs on the plain forward's residuals (max error within 2e-2 and
    mean within 2e-3 of the largest |gradient|: bf16 outputs, p and ds
    rounded to bf16 at the same points, summed in another order). q, k, v,
    do are (B, H, S, D) views of (B, S, H, D) tensors, as the dispatcher
    passes them. `library` is (forward, forward + backward, inputs):
    SDPA's backward is timed as the difference. At D = 256 the records
    take the kernels' ``_d256`` names."""
    import torch
    from x2i_torch.ops import flash_attention as fa
    o, lse = fa.flash_forward_lse(q, k, v, **kw)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa._delta(o_p, do)
    res = (do, lse_p, delta)
    dq = fa.flash_bwd_dq(q, k, v, *res, **kw)
    reduces = fa.DKV_REDUCE_LAUNCHES["dkv_reduce"]
    dk, dv = fa.flash_bwd_dkv(q, k, v, *res, **kw)
    reduces = fa.DKV_REDUCE_LAUNCHES["dkv_reduce"] - reduces
    plain_kw = {n: kw[n] for n in ("causal", "rope") if n in kw}
    dq_p, dk_p, dv_p = fa.flash_backward_plain(
        q, k, v, kw.get("kv_mask"), o_p, lse_p, do, **plain_kw)
    torch.cuda.synchronize()
    lib_fwd, lib_fb, lib_in = library
    lib_bwd_ms = kernel_ms(lib_fb, *lib_in) - kernel_ms(lib_fwd, *lib_in[:3])
    pairs, d = _pairs(q, k, kw), q.shape[-1]
    tables = _tables(kw)
    mask = kw.get("kv_mask")
    shape = {"shape": list(q.shape), "kv_shape": list(k.shape)}
    diff = (o.float() - o_p.float()).abs()
    fwd = {"kernel": f"{fa.launch_name('flash_fwd_lse', d)}[{label}]",
           "max_abs_err": diff.max().item(),
           "mean_abs_err": diff.mean().item(),
           "lse_max_abs_err": (lse - lse_p).abs().max().item(),
           "finite": bool(torch.isfinite(o).all()),
           "ms": kernel_ms(lambda *t: fa.flash_forward_lse(*t, **kw),
                           q, k, v),
           "plain_ms": kernel_ms(lambda *t: fa.flash_attention_plain(
               *t, return_lse=True, **kw), q, k, v),
           "library_ms": kernel_ms(lib_fwd, *lib_in[:3]),
           "library": "SDPA forward (no rope, no lse output)",
           **k1_grid(q.shape)}
    fwd["bound_ms"], fwd["bound_by"] = bound(
        4.0 * pairs * d, nbytes(q, k, v, o, lse, mask, *tables))
    rate(fwd, 4.0 * pairs * d)
    ok = (fwd["finite"] and fwd["max_abs_err"] <= 1e-2
          and fwd["mean_abs_err"] <= 1e-3 and fwd["lse_max_abs_err"] <= 1e-3)
    out = [(fa.launch_name("flash_fwd_lse", d), fwd)]
    for name, got, want, fn, plain, flops in (
            ("flash_bwd_dq", (dq,), (dq_p,), fa.flash_bwd_dq,
             fa.flash_bwd_dq_plain, 6.0),
            ("flash_bwd_dkv", (dk, dv), (dk_p, dv_p), fa.flash_bwd_dkv,
             fa.flash_bwd_dkv_plain, 8.0)):
        errs = [_rel_errors(g_, w_) for g_, w_ in zip(got, want)]
        name = fa.launch_name(name, d)
        rec = {"kernel": f"{name}[{label}]",
               "max_abs_err": max((g_.float() - w_.float()).abs().max()
                                  .item() for g_, w_ in zip(got, want)),
               "max_rel_err": max(e[0] for e in errs),
               "mean_rel_err": max(e[1] for e in errs),
               "finite": all(bool(torch.isfinite(g_).all()) for g_ in got),
               "ms": kernel_ms(lambda *t, f=fn: f(*t, **kw), q, k, v, *res),
               "plain_ms": kernel_ms(lambda *t, f=plain: f(*t, **kw), q, k,
                                     v, *res),
               "library_ms": lib_bwd_ms,
               "library": "SDPA backward: forward + backward by autograd "
                          "minus the forward (both kernels' work, no rope)"}
        rec["bound_ms"], rec["bound_by"] = bound(
            flops * pairs * d, nbytes(q, k, v, *res, mask, *tables, *got))
        rate(rec, flops * pairs * d)
        if name == "flash_bwd_dkv_d256":
            rec.update(dkv_d256(k.shape, q.shape[1], q.shape[2], "rope" in kw,
                                mask is not None or kw.get("causal", False),
                                False, reduces))
            ok = ok and rec["reduce_as_split"]
        ok = ok and (rec["finite"] and rec["max_rel_err"] <= 2e-2
                     and rec["mean_rel_err"] <= 2e-3)
        out.append((name, rec))
    for name, rec in out:
        rec.update(phase="kernels", **shape)
        emit(rec)
        records.setdefault(name, []).append(rec)
    if not ok:
        raise AssertionError(f"{label}: a training attention kernel "
                             f"disagrees with its plain version: {out}")


def _sdpa_lib(q, k, v, do, mask=None):
    """SDPA as ``check_flash_train``'s library: (forward, forward + backward
    by autograd, contiguous (B, H, S, D) inputs) for (B, S, H, D) q, k, v,
    do and an optional bool mask."""
    import torch
    import torch.nn.functional as F
    ins = [t.transpose(1, 2).contiguous() for t in (q, k, v, do)]

    def fwd(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def fwd_bwd(q, k, v, do):
        args = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fwd(*args), args, do)

    return fwd, fwd_bwd, ins


def check_training_attention(g, records):
    """K1 with the lse, K3 and K4 at the distillation step's shapes: the
    FLUX training point (1, 24, 4608, 128), no mask, not causal, rope
    outside the kernels (the trainer's setting) and inside them; the LM's
    14 q / 2 kv heads x 512 x 64 with its kv mask and causal. Also the
    teacher's forward at the FLUX point (K1c: no rope, no lse, the
    pipelined body)."""
    import torch

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    s_txt, grid, heads, d = 512, 128, 24, 128
    s = s_txt + (grid // 2) ** 2
    rope = _rope_tables(s_txt, grid, (16, 56, 56), dev)
    q, k, v, do = (randn(1, s, heads, d) for _ in range(4))
    lib = _sdpa_lib(q, k, v, do)
    check_flash("flash_fwd_pipe[teacher, rope outside]", q, k, v,
                records.setdefault("flash_fwd_pipe", []),
                library=(lib[0], lib[2][:3]))
    bhsd = [t.transpose(1, 2) for t in (q, k, v, do)]
    check_flash_train("FLUX, rope outside", *bhsd, records, lib)
    check_flash_train("FLUX, rope in the kernel", *bhsd, records, lib,
                      rope=rope)
    s, hq, hk, d = 512, 14, 2, 64
    q, do = randn(1, s, hq, d), randn(1, s, hq, d)
    k, v = randn(1, s, hk, d), randn(1, s, hk, d)
    mask = torch.arange(s, device=dev)[None] < 40
    causal_mask = (torch.ones((s, s), dtype=torch.bool, device=dev).tril()
                   & mask[:, None, :])[:, None]
    kr, vr = (t.repeat_interleave(hq // hk, dim=2) for t in (k, v))
    lib = _sdpa_lib(q, kr, vr, do, causal_mask)
    check_flash_train("LM, kv mask, causal",
                      *[t.transpose(1, 2) for t in (q, k, v, do)], records,
                      lib, kv_mask=mask, causal=True)


def _attention_rows_f32(q, k, v, r0, r1, kv_mask, causal):
    """The plain f32 softmax attention of q rows r0..r1 of (B, H, S, D)
    tensors (GQA, kv mask, causal diagonal aligned at row 0): one block of
    rows, so that the (rows, Skv) f32 scores fit beside the model."""
    import torch
    from x2i_torch.ops.flash_attention import NEG_INF
    group = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = (q[:, :, r0:r1].float() @ kf.transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    if kv_mask is not None:
        s.masked_fill_(~kv_mask[:, None, None, :], NEG_INF)
    if causal:
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        s.masked_fill_(cols > rows, NEG_INF)
    return torch.softmax(s, dim=-1) @ vf


# K2's error relative to the size of o: the largest error over the largest
# |o| and the mean error over the mean |o|. The absolute bars alone are
# loose where the softmax spreads over thousands of keys: at the 2048^2
# DiT point |o| is about 0.01. There a kernel that dropped one of its 132
# kv tiles erred by 8% of the mean |o| and 34% of the largest, and the
# right one by 0.2% and 0.6% (PERF.md, NVIDIA H100 80GB HBM3).
K2_REL_MAX, K2_REL_MEAN = 2e-2, 1e-2


def check_flash_chunked(label, q, k, v, records, library, rows_per_block,
                        kv_mask=None, causal=False, name="flash_chunked",
                        with_lse=True):
    """K2 at one shape, with and without the lse (``with_lse``): against its
    plain version (256 x 512 tiles with the block skip against the
    kernel's 128 x 128: o within 1e-2 max and 1e-3 mean absolute error in
    bf16 and within ``K2_REL_MAX`` / ``K2_REL_MEAN`` relative to |o|, the
    lse within 1e-3 in log2 units) and o against the plain f32 attention,
    block of q rows by block (the same bars). Every row of these cases has
    a valid key.
    q, k, v are (B, H, S, D) views of (B, S, H, D) tensors, as the
    dispatcher passes them; `library` is (fn, inputs). The bound
    counts the (query, key) pairs the data needs: valid keys at or below
    the diagonal, whatever tiles an implementation visits."""
    import torch
    from x2i_torch.ops import flash_attention as fa
    kw = dict(kv_mask=kv_mask, causal=causal)
    o = fa.flash_forward_chunked(q, k, v, **kw)
    o_l, lse = (fa.flash_forward_chunked(q, k, v, return_lse=True, **kw)
                if with_lse else (o, None))
    o_p, lse_p = fa.flash_forward_chunked_plain(q, k, v, return_lse=True,
                                                **kw)
    torch.cuda.synchronize()
    diff = (o.float() - o_p.float()).abs()
    o_p_abs = o_p.float().abs()
    ref_max = ref_sum = ref_abs_max = ref_abs_sum = 0.0
    for r0 in range(0, q.shape[2], rows_per_block):
        r1 = min(q.shape[2], r0 + rows_per_block)
        ref = _attention_rows_f32(q, k, v, r0, r1, kv_mask, causal)
        d = (o[:, :, r0:r1].float() - ref).abs()
        ref_max, ref_sum = max(ref_max, d.max().item()), ref_sum + d.sum(
            ).item()
        ref_abs_max = max(ref_abs_max, ref.abs().max().item())
        ref_abs_sum += ref.abs().sum().item()
        del d, ref
    pairs = _pairs(q, k, kw)
    rec = {"phase": "kernels", "kernel": f"{name}[{label}]",
           "shape": list(q.shape), "kv_shape": list(k.shape),
           "causal": causal,
           "valid_keys": None if kv_mask is None else int(kv_mask.sum()),
           "max_abs_err": diff.max().item(),
           "mean_abs_err": diff.mean().item(),
           "rel_max_err": diff.max().item() / o_p_abs.max().item(),
           "rel_mean_err": diff.mean().item() / o_p_abs.mean().item(),
           "lse_max_abs_err": ((lse - lse_p).abs().max().item()
                               if with_lse else None),
           "lse_output_same_o": torch.equal(o, o_l),
           "max_abs_err_vs_f32_attention": ref_max,
           "mean_abs_err_vs_f32_attention": ref_sum / o.numel(),
           "rel_max_err_vs_f32_attention": ref_max / ref_abs_max,
           "rel_mean_err_vs_f32_attention": ref_sum / ref_abs_sum,
           "finite": bool(torch.isfinite(o).all() and (
               not with_lse or torch.isfinite(lse).all())),
           "ms": kernel_ms(lambda *t: fa.flash_forward_chunked(*t, **kw),
                           q, k, v),
           "ms_with_lse": (kernel_ms(lambda *t: fa.flash_forward_chunked(
               *t, return_lse=True, **kw), q, k, v) if with_lse else None),
           # the plain version is thousands of launches per call, more
           # than the launch queue holds behind ``kernel_ms``'s sleep
           # kernel: it is timed call by call, with 4096 x 4096 tiles so
           # that the card and not the host bounds it
           "plain_ms": call_ms(lambda: fa.flash_forward_chunked_plain(
               q, k, v, block_q=4096, block_k=4096, **kw), iters=3),
           "plain_ms_timing": "call_ms, 4096 x 4096 tiles",
           "library_ms": (kernel_ms(library[0], *library[1]) if library
                          else None),
           "library": "SDPA forward on contiguous (B, H, S, D) inputs"
                      + (", bool mask (causal and keys), k/v repeated"
                         if causal or kv_mask is not None else ""),
           "flop": 4.0 * pairs * q.shape[-1]}
    rec["bound_ms"], rec["bound_by"] = bound(
        rec["flop"], nbytes(q, k, v, o, kv_mask))
    rate(rec, rec["flop"])
    emit(rec)
    if not (rec["finite"] and rec["lse_output_same_o"]
            and rec["max_abs_err"] <= 1e-2 and rec["mean_abs_err"] <= 1e-3
            and (not with_lse or rec["lse_max_abs_err"] <= 1e-3)
            and ref_max <= 1e-2
            and rec["mean_abs_err_vs_f32_attention"] <= 1e-3
            and rec["rel_max_err"] <= K2_REL_MAX
            and rec["rel_mean_err"] <= K2_REL_MEAN
            and rec["rel_max_err_vs_f32_attention"] <= K2_REL_MAX
            and rec["rel_mean_err_vs_f32_attention"] <= K2_REL_MEAN):
        raise AssertionError(f"{name}[{label}] disagrees with its plain "
                             f"version: {rec}")
    records.setdefault(name, []).append(rec)


def check_chunked_attention(g, records):
    """K2 at the long-sequence path's shapes: the DiT at 2048^2 (1, 24,
    16896, 128), no mask, not causal; the LM's 32,768-token prefill, 14 q
    heads on 2 kv heads x 64, causal, a right-padded mask that leaves
    30,000 keys valid; and an odd case at D = 128 (batch 2, Sq 640 !=
    Skv 1152, mask and causal together, GQA 6 / 2)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    def masked_sdpa(q, k, v, mask, group):
        sq, skv = q.shape[1], k.shape[1]
        keep = (torch.ones((sq, skv), dtype=torch.bool, device=dev).tril()
                & mask[:, None, :])[:, None]
        ins = [q.transpose(1, 2).contiguous()] + [
            t.transpose(1, 2).repeat_interleave(group, dim=1).contiguous()
            for t in (k, v)]
        return (lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=keep)), ins

    s = 512 + (2048 // 16) ** 2
    q, k, v = (randn(1, s, 24, 128) for _ in range(3))
    lib = (lambda *t: F.scaled_dot_product_attention(*t),
           [t.transpose(1, 2).contiguous() for t in (q, k, v)])
    check_flash_chunked("DiT 2048^2", *(t.transpose(1, 2) for t in (q, k, v)),
                        records, lib, 2048)
    del q, k, v, lib
    s, hq, hk, d = 32768, 14, 2, 64
    q, k, v = randn(1, s, hq, d), randn(1, s, hk, d), randn(1, s, hk, d)
    mask = torch.arange(s, device=dev)[None] < 30000
    check_flash_chunked("LM 32k, kv mask, causal",
                        *(t.transpose(1, 2) for t in (q, k, v)), records,
                        masked_sdpa(q, k, v, mask, hq // hk), 1024,
                        kv_mask=mask, causal=True)
    del q, k, v, mask
    torch.cuda.empty_cache()
    # the 7B LMs' 32k prefill: 28 q heads on 4 kv heads x 128 (group 7)
    s, hq, hk, d = 32768, 28, 4, 128
    q, k, v = randn(1, s, hq, d), randn(1, s, hk, d), randn(1, s, hk, d)
    mask = torch.arange(s, device=dev)[None] < 30000
    check_flash_chunked("LM 32k 7B, kv mask, causal, D 128",
                        *(t.transpose(1, 2) for t in (q, k, v)), records,
                        masked_sdpa(q, k, v, mask, hq // hk), 512,
                        kv_mask=mask, causal=True)
    del q, k, v, mask
    torch.cuda.empty_cache()
    q, k, v = randn(2, 640, 6, 128), randn(2, 1152, 2, 128), \
        randn(2, 1152, 2, 128)
    mask = torch.arange(1152, device=dev)[None] < torch.tensor(
        [[1100], [37]], device=dev)
    check_flash_chunked("Sq != Skv, mask, causal, D 128",
                        *(t.transpose(1, 2) for t in (q, k, v)), records,
                        masked_sdpa(q, k, v, mask, 3), 640, kv_mask=mask,
                        causal=True)


def _distance(got, want):
    """(max abs error, relative L2 error) of got against want, in f32."""
    d = got.float() - want.float()
    return d.abs().max().item(), (d.norm() / want.float().norm()).item()


def check_f32_instance(name, label, fn, plain, f32_in, rest, records,
                       library, library_name, flops, info=None):
    """One f32 instance against its f32 plain version: ``fn(*f32_in,
    *rest)`` (the f32 instance: f32 q, k, v (and do) rounded to bf16 on the
    card), the same call on the inputs rounded to bf16 (the bf16 instance)
    and ``plain(*f32_in, *rest)`` in f32; ``rest`` (the lse and delta) is
    f32 in all three. The bar: for every output, the f32 instance's
    relative L2 distance from the plain version is no larger than the bf16
    instance's (both round the same operands to bf16; the bf16 one rounds
    its outputs too). Reported beside it: whether the f32 outputs rounded
    to bf16 are the bf16 instance's bit for bit (the same body on the same
    rounded operands). Times: the f32 instance, the plain version and
    ``library``, (fn, inputs) or a time in ms; the bound's bytes are the
    f32 inputs' and outputs', its operations the bf16 products the tensor
    cores run (989 TFLOP/s). ``info`` joins the record."""
    import torch

    def outs(x):
        return list(x) if isinstance(x, (tuple, list)) else [x]

    bf16_in = [t.to(torch.bfloat16) for t in f32_in]
    got, got16 = outs(fn(*f32_in, *rest)), outs(fn(*bf16_in, *rest))
    want = outs(plain(*f32_in, *rest))
    torch.cuda.synchronize()
    d32 = [_distance(a, w) for a, w in zip(got, want)]
    d16 = [_distance(a, w) for a, w in zip(got16, want)]
    same = all(torch.equal(a.to(b.dtype), b) for a, b in zip(got, got16))
    lib_ms = (library if isinstance(library, float) or library is None
              else kernel_ms(library[0], *library[1]))
    rec = {"phase": "kernels", "kernel": f"{name}[{label}]",
           "shape": list(f32_in[0].shape), "kv_shape": list(f32_in[1].shape),
           "dtype": "float32",
           "max_abs_err": max(e[0] for e in d32),
           "rel_l2_err": [e[1] for e in d32],
           "bf16_instance_max_abs_err": max(e[0] for e in d16),
           "bf16_instance_rel_l2_err": [e[1] for e in d16],
           "rounded_equals_bf16_instance": same,
           "finite": all(bool(torch.isfinite(t).all()) for t in got),
           "out_dtypes": [str(t.dtype) for t in got],
           "ms": kernel_ms(lambda *t: fn(*t, *rest), *f32_in),
           "plain_ms": kernel_ms(lambda *t: plain(*t, *rest), *f32_in),
           "library_ms": lib_ms, "library": library_name, "flop": flops}
    if name.startswith("flash_fwd"):
        rec.update(k1_grid(f32_in[0].shape, f32=True))
    rec.update(info or {})
    rec["bound_ms"], rec["bound_by"] = bound(
        flops, nbytes(*f32_in, *rest, *got))
    rate(rec, flops)
    emit(rec)
    records.setdefault(name, []).append(rec)
    if not (rec["finite"] and all(t.dtype == torch.float32 for t in got)
            and all(a[1] <= b[1] for a, b in zip(d32, d16))):
        raise AssertionError(f"{name}[{label}]: the f32 instance is farther "
                             f"from its plain version than the bf16 "
                             f"instance: {rec}")


def check_f32_training(g, records, heads: int, d: int, label: str):
    """K1's f32 instance with the lse, K3's and K4's at (1, heads, 4608, d)
    f32, no mask, rope outside (the f32 phase-2 step's attention), each
    against its f32 plain version beside the bf16 instance
    (``check_f32_instance``), K3 and K4 on the plain forward's residuals;
    SDPA in f32 on contiguous copies the library's time (for K3 and K4 its
    forward + backward less its forward). At D = 256 the records take the
    ``_d256`` names."""
    import functools

    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import flash_attention as fa

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).transpose(1, 2)

    def sdpa_times(q, k, v, do):
        ins = [t.contiguous() for t in (q, k, v, do)]

        def fwd(q, k, v):
            return F.scaled_dot_product_attention(q, k, v)

        def fwd_bwd(q, k, v, do):
            args = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fwd(*args), args, do)

        f_ms = kernel_ms(fwd, *ins[:3])
        return f_ms, kernel_ms(fwd_bwd, *ins) - f_ms

    q, k, v, do = (randn(1, 4608, heads, d) for _ in range(4))
    pairs = 4608 * 4608 * heads
    fwd_ms, bwd_ms = sdpa_times(q, k, v, do)
    check_f32_instance(
        fa.launch_name("flash_fwd_lse_f32", d), label, fa.flash_forward_lse,
        functools.partial(fa.flash_attention_plain, return_lse=True),
        [q, k, v], [], records, fwd_ms, "SDPA forward, f32 (no lse output)",
        4.0 * pairs * d)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, return_lse=True)
    res = [lse_p, fa._delta(o_p, do)]
    del o_p
    reduces = fa.DKV_REDUCE_LAUNCHES["dkv_reduce"]
    fa.flash_bwd_dkv(q, k, v, do, *res)
    reduces = fa.DKV_REDUCE_LAUNCHES["dkv_reduce"] - reduces
    for name, fn, plain, flops in (
            ("flash_bwd_dq_f32", fa.flash_bwd_dq, fa.flash_bwd_dq_plain, 6.0),
            ("flash_bwd_dkv_f32", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain,
             8.0)):
        check_f32_instance(
            fa.launch_name(name, d), label, fn, plain, [q, k, v, do], res,
            records, bwd_ms, "SDPA backward, f32: forward + backward by "
            "autograd minus the forward (both kernels' work)",
            flops * pairs * d,
            info=(dkv_d256(k.shape, heads, 4608, False, False, True, reduces)
                  if d == 256 and name == "flash_bwd_dkv_f32" else None))
    if d == 256 and not records["flash_bwd_dkv_f32_d256"][-1][
            "reduce_as_split"]:
        raise AssertionError(f"K4 f32 at D = 256 ran the reduce kernel "
                             f"without a split: "
                             f"{records['flash_bwd_dkv_f32_d256'][-1]}")
    del q, k, v, do, res
    torch.cuda.empty_cache()


def check_f32_attention(g, records):
    """The f32 instances at their paths' shapes, each against its f32 plain
    version beside the bf16 instance (``check_f32_instance``): K1 with the
    lse, K3 and K4 at the f32 phase-2 step's (1, 24, 4608, 128), no mask,
    rope outside (``check_f32_training``); K2 with and without the lse at
    the f32 2048^2 DiT's (1, 24, 16896, 128). The tensors are (B, H, S, D)
    views of (B, S, H, D) storage, as the dispatcher passes them. SDPA in
    f32 on contiguous copies is the library's time."""
    import functools

    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import flash_attention as fa

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).transpose(1, 2)

    check_f32_training(g, records, 24, 128, "phase-2 f32, rope outside")
    s = 512 + (2048 // 16) ** 2
    q, k, v = (randn(1, s, 24, 128) for _ in range(3))
    lib = (lambda *t: F.scaled_dot_product_attention(*t),
           [t.contiguous() for t in (q, k, v)])
    # the plain version with 4096 x 4096 tiles: a few launches a call
    plain = functools.partial(fa.flash_forward_chunked_plain, block_q=4096,
                              block_k=4096)
    for with_lse in (False, True):
        check_f32_instance(
            "flash_chunked_f32", f"DiT 2048^2 f32{', lse' if with_lse else ''}",
            functools.partial(fa.flash_forward_chunked, return_lse=with_lse),
            functools.partial(plain, return_lse=with_lse), [q, k, v], [],
            records, lib, "SDPA forward, f32, contiguous (B, H, S, D)",
            4.0 * s * s * 24 * 128)
    del q, k, v, lib
    torch.cuda.empty_cache()


# the 12 x 256 FLUX DiT (FLUX's width and depth, its heads regrouped: the
# JAX FluxConfig with these three fields set)
D256 = dict(attention_head_dim=256, num_attention_heads=12,
            axes_dims_rope=(32, 112, 112))
D256_PAD_TOKENS = 512 + (960 // 16) ** 2      # 4112: the pad route
# a DiT of 32 heads x 128 (width 4096, MLP 16384): JAX's FluxConfig takes
# it, the registry has none; the route checks of K5-K8's f32 instances at
# those widths
W4096 = dict(num_attention_heads=32)


def check_d256_attention(g, rows, records):
    """K1 and K2 at head dim 256 at the 12 x 256 DiT's shapes, bf16: K1a at
    1024^2 (1, 12, 4608, 256) with per-row qk scales (text and image rows),
    the rope and the qk norm inside; K1b masked with the rope at 960^2,
    4112 tokens padded to 4224 with 112 masked keys (the pad route, the
    bound counting the 4112 kept rows); K2 at 2048^2 (1, 12, 16896, 256),
    no lse. Each against its plain version (``check_flash``'s and
    ``check_flash_chunked``'s bars); SDPA at D = 256 on contiguous inputs
    (no norm, no rope; the masked case with its bool mask) is the
    library's time."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    s_txt, heads, d = 512, D256["num_attention_heads"], 256
    recs = records.setdefault("flash_fwd_rope_d256", [])

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    for px in (1024, 960):
        s = s_txt + (px // 16) ** 2
        pad = -(-s // 128) * 128
        cos, sin = _rope_tables(s_txt, px // 8, D256["axes_dims_rope"], dev)
        q, k = rows(1, pad, heads, d), rows(1, pad, heads, d)
        v = randn(1, pad, heads, d)
        w = [1.0 + 0.1 * torch.randn((2, d), generator=g, device=dev)
             for _ in range(2)]
        per_row = [torch.cat([x[0].expand(s_txt, d),
                              x[1].expand(pad - s_txt, d)]) for x in w]
        qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if pad == s:
            lib = (lambda *t: F.scaled_dot_product_attention(*t),
                   (qc, kc, vc))
            check_flash("flash_fwd_rope_d256[DiT 1024^2, per-row qk "
                        "scales]", q, k, v, recs, library=lib,
                        rope=(cos, sin), qk_norm=(*per_row, 1e-6))
            continue
        mask = torch.arange(pad, device=dev)[None] < s
        tables = tuple(F.pad(t, (0, 0, 0, pad - s)) for t in (cos, sin))
        case = (f"DiT 960^2, the pad route: {s} of {pad} keys, per-row qk "
                f"scales")
        lib = ((lambda *t, m=mask[:, None, None, :]:
                F.scaled_dot_product_attention(*t, attn_mask=m)),
               (qc, kc, vc))
        check_flash(f"flash_fwd_rope_d256[{case}]", q, k, v, recs,
                    library=lib, valid_rows=s, kv_mask=mask, rope=tables,
                    qk_norm=(*per_row, 1e-6))
        recs[-1]["case"] = case
    del q, k, v, qc, kc, vc, lib
    torch.cuda.empty_cache()
    s = s_txt + (2048 // 16) ** 2
    q, k, v = (randn(1, s, heads, d) for _ in range(3))
    lib = (lambda *t: F.scaled_dot_product_attention(*t),
           [t.transpose(1, 2).contiguous() for t in (q, k, v)])
    check_flash_chunked("DiT 2048^2, D 256",
                        *(t.transpose(1, 2) for t in (q, k, v)), records,
                        lib, 1024, name="flash_chunked_d256", with_lse=False)
    del q, k, v, lib
    torch.cuda.empty_cache()


def check_d256_training_attention(g, records):
    """K1 with the lse, K3 and K4 at head dim 256 (``check_flash_train``'s
    bars: o 1e-2 max and 1e-3 mean, the lse 1e-3, the gradients 2e-2 max
    and 2e-3 mean of the largest |gradient|): at the 12 x 256 DiT's
    phase-2 shape (1, 12, 4608, 256) with the rope outside the kernels (the
    trainers' ``rope_in_kernel=False``) and inside them; on the pad route at
    960^2 (4112 of 4224 keys, the rope inside); at a ring shard (1, 12,
    1152, 256), the small grid (K3's 108 blocks of 128 q rows; K4's 216 of
    64 kv rows take no split); then the f32 instances at (1, 12, 4608, 256)
    (``check_f32_training``) and K2 with the lse at a ring of 2's pair at
    2048^2, (1, 12, 8448, 256) (``check_flash_chunked``), and its f32
    instance there (``check_f32_instance``). SDPA at D = 256 is the
    library's time (forward, and forward + backward less the forward)."""
    import functools

    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    s_txt, heads, d = 512, D256["num_attention_heads"], 256

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    def bhsd(*t):
        return [x.transpose(1, 2) for x in t]

    def train(label, q, k, v, do, lib, **kw):
        # each case named in the kernels line
        check_flash_train(label, *bhsd(q, k, v, do), records, lib, **kw)
        for name in ("flash_fwd_lse_d256", "flash_bwd_dq_d256",
                     "flash_bwd_dkv_d256"):
            records[name][-1]["case"] = label

    s = s_txt + (1024 // 16) ** 2
    rope = _rope_tables(s_txt, 128, D256["axes_dims_rope"], dev)
    q, k, v, do = (randn(1, s, heads, d) for _ in range(4))
    lib = _sdpa_lib(q, k, v, do)
    train("12 x 256 DiT, rope outside", q, k, v, do, lib)
    train("12 x 256 DiT, rope in the kernel", q, k, v, do, lib, rope=rope)
    del q, k, v, do, lib
    pad = -(-D256_PAD_TOKENS // 128) * 128
    cos, sin = _rope_tables(s_txt, 960 // 8, D256["axes_dims_rope"], dev)
    tables = tuple(F.pad(t, (0, 0, 0, pad - D256_PAD_TOKENS))
                   for t in (cos, sin))
    mask = torch.arange(pad, device=dev)[None] < D256_PAD_TOKENS
    q, k, v, do = (randn(1, pad, heads, d) for _ in range(4))
    train(f"12 x 256 DiT 960^2, the pad route: {D256_PAD_TOKENS} of {pad} "
          f"keys, rope in the kernel", q, k, v, do,
          _sdpa_lib(q, k, v, do, mask[:, None, None, :]), kv_mask=mask,
          rope=tables)
    del q, k, v, do
    q, k, v, do = (randn(1, s // RING, heads, d) for _ in range(4))
    train("12 x 256 ring shard, 1152 tokens", q, k, v, do,
          _sdpa_lib(q, k, v, do))
    del q, k, v, do
    torch.cuda.empty_cache()
    check_f32_training(g, records, heads, d, "12 x 256 phase-2 f32, rope "
                       "outside")
    s = (s_txt + (2048 // 16) ** 2) // 2
    q, k, v = (randn(1, s, heads, d) for _ in range(3))
    lib = (lambda *t: F.scaled_dot_product_attention(*t),
           [t.transpose(1, 2).contiguous() for t in (q, k, v)])
    label = "12 x 256 ring of 2 pair at 2048^2, lse"
    check_flash_chunked(label, *bhsd(q, k, v), records, lib, 1024,
                        name="flash_chunked_d256", with_lse=True)
    records["flash_chunked_d256"][-1]["case"] = label
    del q, k, v, lib
    # and K2's f32 instance with the lse on the same shape
    q, k, v = (torch.randn((1, s, heads, d), generator=g, device=dev
                           ).transpose(1, 2) for _ in range(3))
    check_f32_instance(
        "flash_chunked_f32_d256", f"{label}, f32",
        functools.partial(fa.flash_forward_chunked, return_lse=True),
        functools.partial(fa.flash_forward_chunked_plain, block_q=4096,
                          block_k=4096, return_lse=True),
        [q, k, v], [], records,
        (lambda *t: F.scaled_dot_product_attention(*t),
         [t.contiguous() for t in (q, k, v)]),
        "SDPA forward, f32, contiguous (B, H, S, D)",
        4.0 * s * s * heads * d)
    records["flash_chunked_f32_d256"][-1]["case"] = f"{label}, f32"
    del q, k, v
    torch.cuda.empty_cache()


def check_f32_glue(g, records):
    """The f32 DiT's fused glue at its 1024^2 shapes: K1's f32 rope-and-norm
    instance at (1, 24, 4608, 128) f32 with per-row qk scales, against its
    f32 plain version beside the bf16 K1a on the same inputs rounded to
    bf16 (``check_f32_instance``: no farther in relative L2; its o rounded
    to bf16 is expected to be the bf16 K1a's bit for bit, and is reported),
    SDPA in f32 (no norm, no rope) the library's time; K5 on f32 rows at
    the DiT's three row counts (4096 image, 512 text, 4608 joint) x 3072
    and at 4608 rows x 4096 (the 32 x 128 DiT's width) and 6144, rows
    whose scale spans four decades, against its plain version within 1e-5
    relative and absolute (f32 row statistics summed in another order),
    ``F.layer_norm`` in f32 the library's time (at batch 1 the same
    function)."""
    import functools

    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import flash_attention as fa
    from x2i_torch.ops import fused_glue as fg

    dev = torch.device("cuda")
    s_txt, grid, heads, d = 512, 128, 24, 128
    s = s_txt + (grid // 2) ** 2

    def f32(*shape):
        return torch.randn(shape, generator=g, device=dev)

    cos, sin = _rope_tables(s_txt, grid, (16, 56, 56), dev)
    q, k, v = (f32(1, s, heads, d).transpose(1, 2) for _ in range(3))
    w = [1.0 + 0.1 * f32(2, d) for _ in range(2)]
    per_row = tuple(torch.cat([x[0].expand(s_txt, d),
                               x[1].expand(s - s_txt, d)]) for x in w)
    kw = dict(rope=(cos, sin), qk_norm=(*per_row, 1e-6))
    lib = (lambda *t: F.scaled_dot_product_attention(*t),
           [t.contiguous() for t in (q, k, v)])
    check_f32_instance(
        "flash_fwd_rope_f32", "DiT 1024^2 f32, per-row qk scales",
        functools.partial(fa.flash_attention, **kw),
        functools.partial(fa.flash_attention_plain, **kw), [q, k, v], [],
        records, lib, "SDPA forward, f32, contiguous (no norm, no rope)",
        4.0 * s * s * heads * d)
    del q, k, v, lib
    torch.cuda.empty_cache()
    recs = records.setdefault("ln_mod_f32", [])
    for rows_n, width in ((4096, 3072), (512, 3072), (4608, 3072),
                          (4608, 4096), (4608, 6144)):
        lead = (1, rows_n, 1)
        sigma = 10.0 ** torch.empty(lead, device=dev).uniform_(
            -2.0, 2.0, generator=g)
        x = f32(1, rows_n, width) * sigma + 3.0 * sigma * f32(*lead)
        shift, scale = 0.5 * f32(1, width), 0.5 * f32(1, width)
        got = fg.ln_mod(x, shift, scale)
        want = fg.ln_mod_plain(x, shift, scale)
        diff = (got - want).abs()
        ok = bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
        rec = {"phase": "kernels", "kernel": "ln_mod_f32",
               "shape": list(x.shape), "dtype": "float32",
               "instance": list(fg.f32_instance(width)),
               "max_abs_err": diff.max().item(),
               "mean_abs_err": diff.mean().item(), "within_1e-5": ok,
               "ms": kernel_ms(lambda t: fg.ln_mod(t, shift, scale), x),
               "plain_ms": kernel_ms(
                   lambda t: fg.ln_mod_plain(t, shift, scale), x),
               "library_ms": kernel_ms(
                   lambda t: F.layer_norm(t, (width,), 1.0 + scale[0],
                                          shift[0], 1e-6), x),
               "library": "F.layer_norm, f32, weight 1 + scale, bias shift",
               "copy_ms": kernel_ms(torch.clone, x)}
        rec["bound_ms"], rec["bound_by"] = bound(
            10.0 * x.numel(), nbytes(x, got, shift, scale), PEAK_F32_FLOPS)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["gb_per_s"] = nbytes(x, got, shift, scale) / rec["ms"] / 1e6
        emit(rec)
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"ln_mod_f32 disagrees with its plain "
                                 f"version: {rec}")
        recs.append(rec)


def phase_kernels(seed: int):
    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import flash_attention as fa
    from x2i_torch.ops import fused_glue as fg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)

    def rows(*shape, mean=3.0):
        """Rows x * sigma + mu, as a residual stream has them: sigma per
        row spans 1e-2..1e2, mu per row is sigma * N(0, mean^2)."""
        lead = (*shape[:-1], 1)
        sigma = 10.0 ** torch.empty(lead, device=dev).uniform_(
            -2.0, 2.0, generator=g)
        mu = sigma * mean * torch.randn(lead, generator=g, device=dev)
        return (torch.randn(shape, generator=g, device=dev) * sigma + mu
                ).to(torch.bfloat16)

    def sdpa(*t):
        return F.scaled_dot_product_attention(*t)

    flash, ln = {}, []
    # K1a: FLUX joint attention at 1024^2 (512 txt + 4096 img tokens)
    s_txt, grid, heads, d = 512, 128, 24, 128
    s = s_txt + (grid // 2) ** 2
    cos, sin = _rope_tables(s_txt, grid, (16, 56, 56), dev)
    q, k, v = rows(1, s, heads, d), rows(1, s, heads, d), randn(1, s, heads, d)
    wq_t, wq_i, wk_t, wk_i = (1.0 + randn(d, scale=0.1).float()
                              for _ in range(4))
    per_row = (lambda tw, iw: torch.cat([tw.expand(s_txt, d),
                                         iw.expand(s - s_txt, d)]))
    lib = (sdpa, [t.transpose(1, 2).contiguous() for t in (q, k, v)])
    recs = flash.setdefault("flash_fwd_rope", [])
    check_flash("flash_fwd_rope[per-row qk scales]", q, k, v, recs,
                library=lib, rope=(cos, sin),
                qk_norm=(per_row(wq_t, wq_i), per_row(wk_t, wk_i), 1e-6))
    check_flash("flash_fwd_rope[shared qk scale]", q, k, v, recs,
                library=lib, rope=(cos, sin), qk_norm=(wq_i, wk_i, 1e-6))
    # k = q and qk scales of 3: every row's score with its own key is
    # about 145 in log2 units, so exp2 overflows f32 unless clamped at 100
    qk = rows(1, s, heads, d, mean=0.0)
    w3 = torch.full((d,), 3.0, device=dev)
    qn = fa._rotate(fa._norm_rows(qk.transpose(1, 2).float(), w3, 1e-6),
                    cos, sin)
    self_score = qn.square().sum(-1) * fa.LOG2_E / math.sqrt(d)
    if not bool((self_score > 100.0).all()):
        raise AssertionError(f"clamp case: a self score is only "
                             f"{self_score.min().item()}")
    check_flash("flash_fwd_rope[scores reach the clamp]", qk, qk, v, recs,
                library=lib, rope=(cos, sin), qk_norm=(w3, w3, 1e-6))
    # K1b: Qwen2 prefill, 14 q / 2 kv heads x 512 x 64, causal, kv mask
    s, hq, hk, d = 512, 14, 2, 64
    q, k, v = randn(1, s, hq, d), randn(1, s, hk, d), randn(1, s, hk, d)
    recs = flash.setdefault("flash_fwd", [])
    for label, first in (("right-padded mask", True),
                         ("row 0 fully masked", False)):
        mask = torch.zeros((1, s), dtype=torch.bool, device=dev)
        mask[:, :40] = True
        mask[:, 0] = first
        causal_mask = (torch.ones((s, s), dtype=torch.bool,
                                  device=dev).tril() & mask[:, None, :])
        qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kr, vr = (t.repeat_interleave(hq // hk, dim=1) for t in (kc, vc))
        lib = ((lambda *t, m=causal_mask[:, None]:
                F.scaled_dot_product_attention(*t, attn_mask=m)),
               (qc, kr, vr))
        check_flash(f"flash_fwd[{label}]", q, k, v, recs, library=lib,
                    host_time=True, kv_mask=mask, causal=True)
    # K1b at the registry's larger LMs, D = 128: 16 q on 2 kv heads (the
    # 3B and 4B, group 8) and 28 on 4 (the 7B LMs, group 7), with 40 and
    # 400 valid keys
    for hq, hk in ((16, 2), (28, 4)):
        q, k, v = randn(1, s, hq, 128), randn(1, s, hk, 128), \
            randn(1, s, hk, 128)
        qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kr, vr = (t.repeat_interleave(hq // hk, dim=1) for t in (kc, vc))
        for valid in (40, 400):
            mask = torch.arange(s, device=dev)[None] < valid
            causal_mask = (torch.ones((s, s), dtype=torch.bool,
                                      device=dev).tril() & mask[:, None, :])
            lib = ((lambda *t, m=causal_mask[:, None]:
                    F.scaled_dot_product_attention(*t, attn_mask=m)),
                   (qc, kr, vr))
            check_flash(f"flash_fwd[{hq}/{hk} heads x 128, {valid} valid "
                        f"keys]", q, k, v, recs, library=lib,
                        host_time=True, kv_mask=mask, causal=True)
    diag_g = torch.Generator(device=dev).manual_seed(seed + 1)
    check_vit_attention(randn, recs, lambda *shape: torch.randn(
        shape, generator=diag_g, device=dev).to(torch.bfloat16))
    check_clip_attention(randn, recs)
    check_clip_attention_f32(g, flash.setdefault("flash_fwd_f32", []))
    check_resampler_attention(randn, recs)
    # K5: ln_mod at the three row counts of the 1024^2 DiT, then at the
    # 2048^2 DiT's (image and joint tokens; its text rows are the same 512)
    for rows_n in (4096, 512, 4608, 16384, 16896):
        x = rows(1, rows_n, 3072)
        shift, scale = randn(1, 3072, scale=0.5), randn(1, 3072, scale=0.5)
        got = fg.ln_mod(x, shift, scale)
        want = fg.ln_mod_plain(x, shift, scale)
        # with shift = scale = 0 the kernel returns its normalized row y:
        # within one bf16 step (2^-7 relative, 1e-4 absolute) of the plain
        # version's (f32 sums in another order), and its modulate of that
        # y is bit for bit the plain version's
        zero = torch.zeros_like(shift)
        y, y_plain = fg.ln_mod(x, zero, zero), fg.ln_mod_plain(x, zero, zero)
        y_ok = bool(((y.float() - y_plain.float()).abs()
                     <= 2.0 ** -7 * y_plain.float().abs() + 1e-4).all())
        mod_ok = torch.equal(got, y * (1.0 + scale[:, None]) + shift[:, None])
        diff = (got.float() - want.float()).abs()
        # at batch 1 the same function is one F.layer_norm call
        w = 1.0 + scale[0]
        rec = {"phase": "kernels", "kernel": "ln_mod",
               "shape": list(x.shape), "max_abs_err": diff.max().item(),
               "mean_abs_err": diff.mean().item(),
               "mismatches": int((diff > 0).sum()),
               "ms": kernel_ms(lambda t: fg.ln_mod(t, shift, scale), x),
               "plain_ms": kernel_ms(
                   lambda t: fg.ln_mod_plain(t, shift, scale), x),
               "library_ms": kernel_ms(
                   lambda t: F.layer_norm(t, (3072,), w, shift[0], 1e-6),
                   x),
               # a copy of x reads and writes the bytes K5 moves: the rate
               # the card reaches on them
               "copy_ms": kernel_ms(torch.clone, x)}
        rec["bound_ms"], rec["bound_by"] = bound(
            10.0 * x.numel(), nbytes(x, got, shift, scale), PEAK_F32_FLOPS)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["gb_per_s"] = nbytes(x, got, shift, scale) / rec["ms"] / 1e6
        rec["y_within_1_ulp"], rec["modulate_exact"] = y_ok, mod_ok
        emit(rec)
        if not (y_ok and mod_ok):
            raise AssertionError(f"ln_mod disagrees with its plain version: "
                                 f"{rec}")
        ln.append(rec)
    recs = {**flash, "ln_mod": ln}
    check_training_attention(g, recs)
    check_chunked_attention(g, recs)
    check_f32_attention(g, recs)
    check_d256_attention(g, rows, recs)
    check_d256_training_attention(g, recs)
    check_f32_glue(g, recs)
    check_glue(g, randn, rows, recs)
    check_gemms(g, rows, recs)
    check_w4a8_gemms(g, rows, recs)
    check_w4_dequant(g, recs)
    check_dequant_gemms(g, rows, recs)
    check_grad_dequant(g, recs)
    check_f32_quant_glue(g, recs)
    check_f32_gemms(g, rows, recs)
    check_f32_dequant(g, recs)
    check_straight_through(g)
    return recs


VIT_TOKENS = 1025                  # a 448 tile's CLS and 32 x 32 patches
VIT_CASE = "ViT: 16 heads x 64, 1025 of 1152 keys, non-causal"
# the same heads at 128 128-row blocks, one wave on the card's 132 SMs,
# beside the ViT's 144 (two waves of 128-row blocks, one at three 64-row
# blocks an SM): what the grid alone costs
VIT_DIAG_CASE = "ViT diagnostic: 16 heads x 64, 897 of 1024 keys, non-causal"


def check_vit_attention(randn, recs, diag_randn):
    """K1 at InternViT-300M's shape, one 448 tile: 16 heads x 64, 1025
    tokens padded to 1152 with 127 masked keys, non-causal, no rope, as
    the dispatcher's pad route hands it to the exact body (the padded q
    rows are sliced off after it; the bound counts the 1025 kept); then
    the diagnostic beside it, the same heads at 1024 rows with 127 masked
    keys, drawn by ``diag_randn`` (a generator of its own, so that the
    checks after it see the draws they saw without it). SDPA on the same
    padded, masked tensors is the library's time."""
    import torch
    import torch.nn.functional as F

    for case, pad, valid, draw in (
            (VIT_CASE, 1152, VIT_TOKENS, randn),
            (VIT_DIAG_CASE, 1024, 1024 - 127, diag_randn)):
        q, k, v = (draw(1, pad, 16, 64) for _ in range(3))
        mask = torch.arange(pad, device=q.device)[None] < valid
        qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = ((lambda *t, m=mask[:, None, None, :]:
                F.scaled_dot_product_attention(*t, attn_mask=m)),
               (qc, kc, vc))
        check_flash(f"flash_fwd[{case}]", q, k, v, recs, library=lib,
                    host_time=True, valid_rows=valid, kv_mask=mask)
        recs[-1]["case"] = case


CLIP_TOKENS = 257                  # CLIP ViT-L/14's CLS and 16 x 16 patches
CLIP_IMAGES = 4                    # the eval phase's batch
CLIP_CASE = "CLIP ViT-L/14: 16 heads x 64, 257 of 384 keys, non-causal"


def check_clip_attention(randn, recs):
    """K1 at the CLIP vision tower's shape in bf16, the eval phase's batch
    of 4 images: 16 heads x 64, 257 tokens padded to 384 with 127 masked
    keys, non-causal, no rope, as the dispatcher's pad route hands it to
    the exact body (the bound counts the 257 kept q rows). SDPA on the
    same padded, masked tensors is the library's time."""
    import torch
    import torch.nn.functional as F

    pad = 384
    q, k, v = (randn(CLIP_IMAGES, pad, 16, 64) for _ in range(3))
    mask = (torch.arange(pad, device=q.device)[None] < CLIP_TOKENS).expand(
        CLIP_IMAGES, pad).contiguous()
    qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = ((lambda *t, m=mask[:, None, None, :]:
            F.scaled_dot_product_attention(*t, attn_mask=m)), (qc, kc, vc))
    check_flash(f"flash_fwd[{CLIP_CASE}]", q, k, v, recs, library=lib,
                host_time=True, valid_rows=CLIP_TOKENS, kv_mask=mask)
    recs[-1]["case"] = CLIP_CASE


def check_clip_attention_f32(g, recs):
    """K1's f32 instance at the same CLIP shape, as the f32 scorer's pad
    route hands it over: f32 q, k, v (rounded to bf16 on the card, so the
    bars are the bf16 instances': 1e-2 max, 1e-3 mean absolute of the
    plain version's f32 attention) and an f32 output. SDPA in f32 on the
    same padded, masked tensors is the library's time. The bound's bytes
    are the f32 tensors'; its operations are the bf16 products the tensor
    cores run."""
    import torch
    import torch.nn.functional as F

    pad = 384
    q, k, v = (torch.randn((CLIP_IMAGES, pad, 16, 64), generator=g,
                           device="cuda") for _ in range(3))
    mask = (torch.arange(pad, device=q.device)[None] < CLIP_TOKENS).expand(
        CLIP_IMAGES, pad).contiguous()
    qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = ((lambda *t, m=mask[:, None, None, :]:
            F.scaled_dot_product_attention(*t, attn_mask=m)), (qc, kc, vc))
    check_flash(f"flash_fwd_f32[{CLIP_CASE}]", q, k, v, recs, library=lib,
                host_time=True, valid_rows=CLIP_TOKENS, kv_mask=mask)
    recs[-1]["case"] = CLIP_CASE


# MiniCPM-o's resampler: the patch counts of the slices of one batch
RESAMPLER_SLICES = ((1024,), (1024, 600))


def check_resampler_attention(randn, recs):
    """K1 at MiniCPM-o's resampler: 64 queries (28 heads x 128, the same
    rows for every slice) padded to 128 rows, on each slice's patches
    with the patch mask, non-causal, no rope, as the dispatcher's pad
    route hands them to the exact body: one 448^2 slice (1024 patches, no
    key padding) and a batch of two slices of 1024 and 600 patches (the
    second's 424 masked keys inside its kv tiles). The bound counts the 64
    kept rows and the keys the mask keeps; the library's time is SDPA on
    the 64 query rows with the patch mask (``library_padded_ms``: SDPA on
    the pad route's 128 rows)."""
    import torch
    import torch.nn.functional as F

    for lengths in RESAMPLER_SLICES:
        n, skv = len(lengths), max(lengths)
        q = torch.zeros((n, 128, 28, 128), dtype=torch.bfloat16,
                        device="cuda")
        q[:, :64] = randn(1, 64, 28, 128)
        k, v = randn(n, skv, 28, 128), randn(n, skv, 28, 128)
        mask = (torch.arange(skv, device="cuda")[None]
                < torch.tensor(lengths, device="cuda")[:, None])
        qc, kc, vc = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa(*t, m=mask[:, None, None, :]):
            return F.scaled_dot_product_attention(*t, attn_mask=m)
        case = (f"resampler: 28 heads x 128, 64 of 128 q rows, "
                f"{' + '.join(map(str, lengths))} of {n} x {skv} keys, "
                f"non-causal")
        check_flash(f"flash_fwd[{case}]", q, k, v, recs,
                    library=(sdpa, (qc[:, :, :64].contiguous(), kc, vc)),
                    host_time=True, valid_rows=64, kv_mask=mask)
        recs[-1]["case"] = case
        recs[-1]["library_padded_ms"] = kernel_ms(sdpa, qc, kc, vc)
        emit({"phase": "kernels", "case": case,
              "library_padded_ms": recs[-1]["library_padded_ms"]})


def check_glue(g, randn, rows, recs):
    """K6, K7 and K8 at the DiT's row counts (4096 image, 512 text and
    4608 joint tokens), K6 also at batch 2, and K8 at the inputs of the
    unfused w8a8 layers, at K7's width and on tie rows (every quotient k +
    0.5: the test of the quantization epilogue's rounding). K8 bit for
    bit, its counter stepping by one a call, and at 3072 beside the
    generic kernel (``ms_by_body``); K6 codes within one step with at most
    1% flipped and scales within one bf16 step (a normalized value can
    flip by one bf16 step, as in ln_mod), and bit for bit K8 after K5; K7
    the JAX package's bar, codes within one step, at most 10% flipped,
    scales within rtol 2e-2 (its exp form of the tanh against PyTorch's
    tanhf)."""
    import torch
    from x2i_torch.ops import fused_glue as fg

    # x_embedder, context_embedder, the time and pooled embedders' in
    # layers, and the mods pass (4 rows; also the width of the embedders'
    # out layers and norm_out)
    cases = [("quant_rows", label, shape) for label, shape in (
        ("x_embedder", (1, 4096, 64)), ("context_embedder", (1, 512, 4096)),
        ("time in", (1, 256)), ("pooled in", (1, 768)),
        ("mods pass", (4, 3072)))]
    for n_rows in (4096, 512, 4608):
        cases.append(("quant_rows", f"attention, {n_rows} rows",
                      (1, n_rows, 3072)))
        cases.append(("gelu_quant", f"{n_rows} rows", (1, n_rows, 12288)))
        cases.append(("ln_mod_quant", f"{n_rows} rows", (1, n_rows, 3072)))
    cases += [("ln_mod_quant", "batch 2", (2, 512, 3072)),
              ("quant_rows", "K7's width, 4608 rows", (1, 4608, 12288)),
              ("quant_rows", "tie rows", (1, 256, 12288)),
              ("quant_rows", "tie rows", (64, 3072)),
              # the int8 7B LM's decode row: its width and its MLP's
              ("quant_rows", "7B decode row", (1, 1, 3584)),
              ("quant_rows", "7B decode MLP row", (1, 1, 18944))]
    reason = {"ln_mod_quant": "no one PyTorch call computes LayerNorm + "
                              "modulate + int8 quantization",
              "gelu_quant": "no one PyTorch call computes gelu + int8 "
                            "quantization",
              "quant_rows": "no one PyTorch call computes a per-row int8 "
                            "quantization"}
    # per-element operations of the row pass (f32, outside tensor cores)
    ops = {"ln_mod_quant": 16, "gelu_quant": 16, "quant_rows": 5}
    for name, label, shape in cases:
        # gelu's inputs are centred, as MLP pre-activations are: on a row
        # far below zero gelu is ~0 everywhere, the scale is the floor
        # 1e-6 / 127, and ulps of tanh become whole codes
        if label == "tie rows":
            x = tie_rows(g, math.prod(shape[:-1]), shape[-1]).view(shape)
        else:
            x = rows(*shape, mean=0.0 if name == "gelu_quant" else 3.0)
        if name == "ln_mod_quant":
            batch = shape[0]
            mod = randn(batch, 6 * 3072, scale=0.5)
            inputs = (x, mod[:, :3072], mod[:, 3072:6144])
        else:
            inputs = (x,)
        fn, plain = getattr(fg, name), getattr(fg, name + "_plain")
        before = dict(fg.LAUNCHES)
        q, a = fn(*inputs)
        counted = fg.LAUNCHES == dict(before, **{name: before[name] + 1})
        qp, ap = plain(*inputs)
        torch.cuda.synchronize()
        d = (q.int() - qp.int()).abs()
        scale_rel = ((a - ap).abs() / ap).max().item()
        rec = {"phase": "kernels", "kernel": name, "case": label,
               "shape": list(x.shape),
               # on the dequantized values
               "max_abs_err": (q.float() * a - qp.float() * ap).abs().max()
               .item(),
               "max_code_diff": int(d.max()), "codes_flipped": int(
                   (d != 0).sum()), "codes": d.numel(),
               "max_scale_rel_err": scale_rel, "counted_once": counted,
               "ms": kernel_ms(fn, *inputs),
               "plain_ms": kernel_ms(plain, *inputs),
               "library_ms": None, "library": reason[name]}
        rec["bound_ms"], rec["bound_by"] = bound(
            ops[name] * x.numel(), nbytes(*inputs, q, a), PEAK_F32_FLOPS)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["gb_per_s"] = nbytes(*inputs, q, a) / rec["ms"] / 1e6
        flips = rec["codes_flipped"] / rec["codes"]
        ok = {"quant_rows": torch.equal(q, qp) and torch.equal(a, ap),
              "ln_mod_quant": (rec["max_code_diff"] <= 1 and flips <= 0.01
                               and scale_rel <= 2.0 ** -7),
              "gelu_quant": (rec["max_code_diff"] <= 1 and flips <= 0.10
                             and scale_rel <= 2e-2)}[name] and counted
        if name == "ln_mod_quant":
            # one LayerNorm + modulate in K5 and K6: K6 is K8 after K5
            q8, a8 = fg.quant_rows(fg.ln_mod(*inputs))
            rec["k8_after_k5_exact"] = (torch.equal(q, q8)
                                        and torch.equal(a, a8))
            ok = ok and rec["k8_after_k5_exact"]
        if name == "quant_rows" and shape[-1] == 3072 and len(shape) == 3:
            # K8's warp body (launched) and the generic kernel at a block
            # a row, as K7 takes it at this width: the same bits
            generic = ("generic", 256)
            qg, ag = fg._quant_rows_cuda(x, instance=generic)
            rec["generic_exact"] = torch.equal(qg, qp) and torch.equal(ag,
                                                                       ap)
            rec["ms_by_body"] = {
                "warp": rec["ms"],
                "generic": kernel_ms(
                    lambda t: fg._quant_rows_cuda(t, instance=generic), x)}
            ok = ok and rec["generic_exact"]
        emit(rec)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"or was not counted once: {rec}")
        recs.setdefault(name, []).append(rec)


def tie_rows(g, n: int, d: int, dtype=None):
    """n rows of d values (2k + 1) / 16, k in [-127, 126], each row
    with one value of magnitude 15.875 = 127 / 8: the row scale is 2^-3
    exactly and every quotient lands on k + 0.5, where the codes round
    half to even; bf16, or ``dtype`` (the same values: f32 holds them)."""
    import torch
    dev = torch.device("cuda")
    k = torch.randint(-127, 127, (n, d), generator=g, device=dev)
    x = (2 * k + 1).float() / 16
    at = torch.randint(0, d, (n,), generator=g, device=dev)
    sign = torch.randint(0, 2, (n,), generator=g, device=dev) * 2 - 1
    x[torch.arange(n, device=dev), at] = 15.875 * sign
    return x.to(dtype or torch.bfloat16)


# the DiT's int8 products at 1024^2: (label, M, K, N, weight width, k0,
# addend, bias)
GEMM_SHAPES = (
    ("single q/k/v", 4608, 3072, 3072, None, 0, False, True),
    ("single mlp_in", 4608, 3072, 12288, None, 0, False, True),
    ("single out, attn chunk", 4608, 3072, 3072, 15360, 0, False, False),
    ("single out, mlp chunk + part + bias", 4608, 12288, 3072, 15360, 3072,
     True, True),
    ("double img mlp_out", 4096, 12288, 3072, None, 0, False, True),
    ("context_embedder", 512, 4096, 3072, None, 0, False, True),
    ("double adaLN mods, 4 steps", 4, 3072, 18432, None, 0, False, True),
    ("norm_out", 1, 3072, 6144, None, 0, False, True),
    ("x_embedder", 4096, 64, 3072, None, 0, False, True),
    ("proj_out", 4096, 3072, 64, None, 0, False, True),
    ("time in_layer", 1, 256, 3072, None, 0, False, True),
    ("pooled in_layer", 1, 768, 3072, None, 0, False, True),
)
GEMM_MAIN = "single mlp_in"
# the int8 7B LM's products (q/k/v/o, gate/up, down; Qwen2.5-VL-7B: 3584
# wide, 4 kv heads x 128, MLP 18944) at one decode row and at the
# 512-token prefill
LM_GEMM_SHAPES = tuple(
    (f"7B {stage} {name}", m, k, n, None, 0, False, bias)
    for stage, m in (("decode", 1), ("prefill", 512))
    for name, k, n, bias in (("q/o", 3584, 3584, True),
                             ("k/v", 3584, 512, True),
                             ("gate/up", 3584, 18944, False),
                             ("down", 18944, 3584, False)))


def check_gemms(g, rows, recs):
    """The int8 GEMM at the main path's shapes and the int8 7B LM's: its
    int32 sum exact, its bf16 output within one bf16 step of the plain
    version's. Yardsticks: ``torch._int_mm`` (the int32 product alone; it
    refuses M <= 16) and the bf16 ``F.linear`` of the same shape."""
    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import fused_glue as fg
    from x2i_torch.ops import int8_gemm as ig
    from x2i_torch.ops.quant import quantize_kernel

    dev = torch.device("cuda")
    for label, m, k, n, width, k0, with_add, with_bias in (GEMM_SHAPES
                                                          + LM_GEMM_SHAPES):
        width = width or k
        wf = torch.randn((n, width), generator=g, device=dev) / width ** 0.5
        q, scale = quantize_kernel(wf.t())
        qw = q.t().contiguous()
        del wf, q
        xq, a = fg.quant_rows_plain(rows(m, k))
        bias = ((torch.randn(n, generator=g, device=dev) * 0.1)
                .to(torch.bfloat16) if with_bias else None)
        add = (torch.randn((m, n), generator=g, device=dev)
               .to(torch.bfloat16) if with_add else None)
        acc_exact = torch.equal(ig.int8_matmul_acc(xq, qw, k0),
                                ig.int8_matmul_acc_plain(xq, qw, k0))
        extra = (add,) if with_add else ()

        def kern(x, s, w, *d):
            return ig.int8_linear(x, s, w, scale, bias, k0,
                                  d[0] if d else None)

        def plain(x, s, w, *d):
            return ig.int8_linear_plain(x, s, w, scale, bias, k0,
                                        d[0] if d else None)

        got, want = kern(xq, a, qw, *extra), plain(xq, a, qw, *extra)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        one_step = bool((diff <= 2.0 ** -7 * want.float().abs()).all())
        w_k = qw[:, k0:k0 + k].contiguous()
        try:
            lib_ms, lib = kernel_ms(torch._int_mm, xq, w_k.t()), \
                "torch._int_mm (int32 product only)"
        except RuntimeError as err:        # the library refuses the shape
            lib_ms, lib = None, f"torch._int_mm refuses it: {err}"[:200]
        xb, wb = xq.to(torch.bfloat16), w_k.to(torch.bfloat16)
        rec = {"phase": "kernels", "kernel": "int8_gemm", "case": label,
               "shape": [m, k, n], "k0": k0, "acc_exact": acc_exact,
               "max_abs_err": diff.max().item(),
               "mismatches": int((diff > 0).sum()),
               "within_one_bf16_step": one_step,
               "ms": kernel_ms(kern, xq, a, qw, *extra),
               "plain_ms": kernel_ms(plain, xq, a, qw, *extra),
               "library_ms": lib_ms, "library": lib,
               "bf16_linear_ms": kernel_ms(F.linear, xb, wb)}
        rec["bound_ms"], rec["bound_by"] = bound(
            2.0 * m * n * k, nbytes(xq, a, w_k, scale, bias, add, got),
            PEAK_INT8_OPS)
        rec["tops"] = 2.0 * m * n * k / rec["ms"] / 1e9
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        emit(rec)
        if not (acc_exact and one_step):
            raise AssertionError(f"int8 GEMM disagrees with its plain "
                                 f"version: {rec}")
        recs.setdefault("int8_gemm", []).append(rec)


# chunks of the single block's 15360-wide out weight (in/2 = 7680) beside
# the DiT's two: one in the high half, and one that starts in the low half
# and ends in the high one off the DiT's split
W4A8_CHUNKS = (
    ("single out, a chunk in the high half", 4608, 3072, 3072, 15360, 9216,
     True, True),
    ("single out, a chunk across the half", 4608, 4096, 3072, 15360, 5632,
     True, False))


def check_w4a8_gemms(g, rows, recs):
    """The w4a8 GEMM at the int8 GEMM's twelve shapes and the LM's, and at
    the chunks of ``W4A8_CHUNKS``, on weights from ``quantize_kernel_w4a8``
    (x_embedder's 64 inputs in two groups of 32; the single block's mlp
    chunk crosses in/2 = 7680): its int32 sum exact and its bf16 output,
    addend and bias included, bit for bit the plain version's (the
    epilogue's rounding points are the plain version's). No one PyTorch
    call computes it (``library_ms`` null); beside it, the int8 GEMM on the
    materialized operand code x m (what the kernel loses to its
    conversion) and the bf16 ``F.linear``. The bound counts the packed
    weight at half a byte a code."""
    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import fused_glue as fg
    from x2i_torch.ops import int4_gemm as i4
    from x2i_torch.ops import int8_gemm as ig
    from x2i_torch.ops.quant import quantize_kernel_w4a8

    dev = torch.device("cuda")
    for label, m, k, n, width, k0, with_add, with_bias in (
            GEMM_SHAPES + LM_GEMM_SHAPES + W4A8_CHUNKS):
        width = width or k
        wf = torch.randn((n, width), generator=g, device=dev) / width ** 0.5
        pk, ms, scale = quantize_kernel_w4a8(wf.t())
        pw = pk.t().contiguous()
        del wf, pk
        xq, a = fg.quant_rows_plain(rows(m, k))
        bias = ((torch.randn(n, generator=g, device=dev) * 0.1)
                .to(torch.bfloat16) if with_bias else None)
        add = (torch.randn((m, n), generator=g, device=dev)
               .to(torch.bfloat16) if with_add else None)
        acc_exact = torch.equal(i4.w4a8_matmul_acc(xq, pw, ms, k0),
                                i4.w4a8_matmul_acc_plain(xq, pw, ms, k0))
        extra = (add,) if with_add else ()

        def kern(x, s, w, *d):
            return i4.w4a8_linear(x, s, w, ms, scale, bias, k0,
                                  d[0] if d else None)

        def plain(x, s, w, *d):
            return i4.w4a8_linear_plain(x, s, w, ms, scale, bias, k0,
                                        d[0] if d else None)

        def int8(x, s, w, *d):
            return ig.int8_linear(x, s, w, scale, bias, 0,
                                  d[0] if d else None)

        got, want = kern(xq, a, pw, *extra), plain(xq, a, pw, *extra)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        codes = i4.w4a8_codes(pw, ms)[:, k0:k0 + k].contiguous()
        xb, wb = xq.to(torch.bfloat16), codes.to(torch.bfloat16)
        rec = {"phase": "kernels", "kernel": "w4a8_gemm", "case": label,
               "shape": [m, k, n], "k0": k0, "in_features": width,
               "groups": ms.shape[0], "acc_exact": acc_exact,
               "max_abs_err": diff.max().item(),
               "mismatches": int((diff > 0).sum()),
               "bit_for_bit": torch.equal(got, want),
               "ms": kernel_ms(kern, xq, a, pw, *extra),
               "plain_ms": kernel_ms(plain, xq, a, pw, *extra),
               "library_ms": None,
               "library": "none: no one PyTorch call computes it",
               "int8_gemm_ms": kernel_ms(int8, xq, a, codes, *extra),
               "bf16_linear_ms": kernel_ms(F.linear, xb, wb)}
        # the packed codes of the chunk's K inputs and the multipliers of
        # its groups
        weight_bytes = n * k // 2 + n * (k // (width // ms.shape[0]))
        rec["bound_ms"], rec["bound_by"] = bound(
            2.0 * m * n * k,
            nbytes(xq, a, scale, bias, add, got) + weight_bytes,
            PEAK_INT8_OPS)
        rec["tops"] = 2.0 * m * n * k / rec["ms"] / 1e9
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["vs_int8_gemm"] = rec["ms"] / rec["int8_gemm_ms"]
        emit(rec)
        if not (acc_exact and rec["bit_for_bit"]):
            raise AssertionError(f"w4a8 GEMM disagrees with its plain "
                                 f"version: {rec}")
        recs.setdefault("w4a8_gemm", []).append(rec)


# the w4 DiT's dense weights: (label, out, in)
DEQUANT_SHAPES = (
    ("single mlp_in", 12288, 3072),
    ("single out", 3072, 15360),
    ("single q/k/v", 3072, 3072),
    ("double img mlp_out", 3072, 12288),
    ("double adaLN mods", 18432, 3072),
    ("x_embedder", 3072, 64),
    ("proj_out", 64, 3072),
    ("time in_layer", 3072, 256),
)
DEQUANT_MAIN = "single mlp_in"


def check_w4_dequant(g, recs):
    """The w4 dequantize kernel at the DiT's weight shapes, on weights from
    ``quantize_kernel_w4``: bit for bit its plain version (the JAX
    ``_dequant_w4`` chain in bf16), timed against it and against its
    bound (bytes: the packed codes and the scales read once, the bf16
    weight written once). No one PyTorch call computes it."""
    import torch
    from x2i_torch.ops import int4_gemm as i4
    from x2i_torch.ops.quant import quantize_kernel_w4

    dev = torch.device("cuda")
    for label, n, inn in DEQUANT_SHAPES:
        wf = torch.randn((n, inn), generator=g, device=dev) / inn ** 0.5
        pk, sc = quantize_kernel_w4(wf.t())
        pw = pk.t().contiguous()
        del wf, pk
        got, want = i4.w4_dequant(pw, sc), i4.w4_dequant_plain(pw, sc)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        rec = {"phase": "kernels", "kernel": "w4_dequant", "case": label,
               "shape": [n, inn], "groups": sc.shape[0],
               "bit_for_bit": torch.equal(got, want),
               "max_abs_err": diff.max().item(),
               "ms": kernel_ms(i4.w4_dequant, pw, sc),
               "plain_ms": kernel_ms(i4.w4_dequant_plain, pw, sc),
               "library_ms": None,
               "library": "none: no one PyTorch call computes it",
               # a copy of the bf16 weight: the rate the card reaches on
               # the bytes it writes
               "copy_ms": kernel_ms(torch.clone, got)}
        rec["bound_ms"], rec["bound_by"] = bound(
            float(n * inn), nbytes(pw, sc, got), PEAK_F32_FLOPS)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        emit(rec)
        if not rec["bit_for_bit"]:
            raise AssertionError(f"w4 dequantize kernel disagrees with its "
                                 f"plain version: {rec}")
        recs.setdefault("w4_dequant", []).append(rec)


# the dequantizing GEMM's products: the w4 / w8 DiT's dense weights of
# ``DEQUANT_SHAPES`` at the rows that multiply them at 1024^2, and the main
# weight at one row and at the 4 adaLN rows
DEQUANT_GEMM_ROWS = {"single mlp_in": 4608, "single out": 4608,
                     "single q/k/v": 4608, "double img mlp_out": 4096,
                     "double adaLN mods": 4, "x_embedder": 4096,
                     "proj_out": 4096, "time in_layer": 1}
DEQUANT_GEMM_SHAPES = tuple(
    (label, DEQUANT_GEMM_ROWS[label], inn, n)
    for label, n, inn in DEQUANT_SHAPES) + (
    ("single mlp_in, 1 row", 1, 3072, 12288),
    ("single mlp_in, 4 rows", 4, 3072, 12288))
DEQUANT_GEMM_MAIN = "single mlp_in"
# (mode, w4 group) of the checked weights; the first is the main path's
DEQUANT_GEMM_MODES = (("w4", 128), ("w4", 64), ("w8", None))


def check_dequant_gemms(g, rows, recs, shapes=DEQUANT_GEMM_SHAPES,
                        modes=DEQUANT_GEMM_MODES,
                        timed=(DEQUANT_GEMM_MAIN,), biased: bool = True):
    """The dequantizing GEMM of the w4 and w8 modes at
    ``DEQUANT_GEMM_SHAPES`` (groups of 128 and 64 in w4), with the bias of
    the DiT's layers and, at the main weight, without it: its converted
    weight, dumped by the kernel, bit for bit the dequantize kernel's
    (``w4_dequant`` / ``int8_dequant``); its output within the bar of the
    plain version (f32 sums in another order, then two bf16 roundings, of
    the product and of the sum with the bias): |got - want| <= 2^-7
    (|want| + |product|) + 2^-12 max |product|, product the plain output
    without the bias. No one PyTorch call computes it from the codes
    (``library_ms`` null); beside it ``F.linear`` on the materialized bf16
    weight (``linear_ms``) and the dequantize kernel followed by it
    (``dequant_linear_ms``, the route the w4 mode took before). The bound
    counts the codes (a byte, or half a byte, a weight) and the scales.
    ``shapes``, ``modes``: other products (the tensor-parallel members');
    ``timed``: the labels whose time is taken; ``biased=False``: only
    products without a bias (a row-split layer's parts)."""
    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import int4_gemm as i4
    from x2i_torch.ops import int8_gemm as ig
    from x2i_torch.ops.quant import quantize_kernel, quantize_kernel_w4

    dev = torch.device("cuda")
    for mode, group in modes:
        for label, m, inn, n in shapes:
            wf = torch.randn((n, inn), generator=g, device=dev) / inn ** 0.5
            if mode == "w8":
                q, scale = quantize_kernel(wf.t())
                codes, dequant = q.t().contiguous(), ig.int8_dequant
            else:
                pk, scale = quantize_kernel_w4(wf.t(), group)
                codes, dequant = pk.t().contiguous(), i4.w4_dequant
            del wf
            x = rows(m, inn)
            main = label in timed and group != 64
            biases = (((torch.randn(n, generator=g, device=dev) * 0.1)
                       .to(torch.bfloat16),) if biased else ()) + (
                (None,) if main or not biased else ())
            for bias in biases:
                weight = dequant(codes, scale)
                dumped = i4.dequant_gemm_weight(x, codes, scale, mode)
                got = i4.dequant_linear(x, codes, scale, bias, mode)
                want = i4.dequant_linear_plain(x, codes, scale, bias, mode)
                prod = i4.dequant_linear_plain(x, codes, scale, None, mode)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                bar = (2.0 ** -7 * (want.float().abs() + prod.float().abs())
                       + 2.0 ** -12 * prod.float().abs().max())
                rec = {"phase": "kernels", "kernel": "dequant_gemm",
                       "case": label + ("" if bias is not None
                                        else ", no bias"),
                       "mode": mode, "groups": scale.shape[0]
                       if mode == "w4" else 1, "shape": [m, inn, n],
                       "weight_bit_for_bit": torch.equal(dumped, weight),
                       "max_abs_err": diff.max().item(),
                       "rel_l2_err": ((got.float() - want.float()).norm()
                                      / want.float().norm()).item(),
                       "within_bar": bool((diff <= bar).all())}
                if main:
                    rec.update({
                        "ms": kernel_ms(lambda t: i4.dequant_linear(
                            t, codes, scale, bias, mode), x),
                        "plain_ms": kernel_ms(lambda t: i4.dequant_linear_plain(
                            t, codes, scale, bias, mode), x),
                        "library_ms": None,
                        "library": "none: no one PyTorch call computes it",
                        "linear_ms": kernel_ms(
                            lambda t: F.linear(t, weight, bias), x),
                        "dequant_linear_ms": kernel_ms(
                            lambda t: F.linear(t, dequant(codes, scale),
                                               bias), x)})
                    rec["bound_ms"], rec["bound_by"] = bound(
                        2.0 * m * n * inn,
                        nbytes(x, codes, scale, bias, got))
                    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
                    rec["tflops"] = 2.0 * m * n * inn / rec["ms"] / 1e9
                elif m <= 4:
                    # a few rows: reading the codes bounds it
                    rec["ms"] = kernel_ms(lambda t: i4.dequant_linear(
                        t, codes, scale, bias, mode), x)
                    rec["linear_ms"] = kernel_ms(
                        lambda t: F.linear(t, weight, bias), x)
                    rec["bound_ms"], rec["bound_by"] = bound(
                        2.0 * m * n * inn,
                        nbytes(x, codes, scale, bias, got))
                emit(rec)
                if not (rec["weight_bit_for_bit"] and rec["within_bar"]):
                    raise AssertionError(f"the dequantizing GEMM disagrees "
                                         f"with its plain version: {rec}")
                recs.setdefault("dequant_gemm", []).append(rec)


def check_grad_dequant(g, recs):
    """The straight-through backward's dequantize kernels (int8: w8 and
    w8a8; w4a8) at the DiT's weight shapes, 3072 -> 12288 and 12288 ->
    3072 among them, on weights from ``quantize_kernel`` and
    ``quantize_kernel_w4a8``: bit for bit their plain versions (the JAX
    backward's dequantize in bf16), timed against them and against their
    bound (bytes: the codes, multipliers and scales read once, the bf16
    weight written once), a ``torch.clone`` of the weight beside them (the
    rate the card reaches on the bytes it writes). No one PyTorch call
    computes either."""
    import torch
    from x2i_torch.ops import int4_gemm as i4
    from x2i_torch.ops import int8_gemm as i8
    from x2i_torch.ops.quant import quantize_kernel, quantize_kernel_w4a8

    dev = torch.device("cuda")
    for label, n, inn in DEQUANT_SHAPES:
        wf = torch.randn((n, inn), generator=g, device=dev) / inn ** 0.5
        q, s8 = quantize_kernel(wf.t())
        qw = q.t().contiguous()
        pk, m, s4 = quantize_kernel_w4a8(wf.t())
        pw = pk.t().contiguous()
        del wf, q, pk
        # (name, kernel, plain version, inputs, operations: the int8
        # code times the scale; the int4 code times m times the scale)
        for name, fn, plain, args, ops in (
                ("int8_dequant", i8.int8_dequant, i8.int8_dequant_plain,
                 (qw, s8), n * inn),
                ("w4a8_dequant", i4.w4a8_dequant, i4.w4a8_dequant_plain,
                 (pw, m, s4), 2 * n * inn)):
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            rec = {"phase": "kernels", "kernel": name, "case": label,
                   "shape": [n, inn], "bit_for_bit": torch.equal(got, want),
                   "max_abs_err": (got.float() - want.float()).abs().max()
                   .item(),
                   "ms": kernel_ms(fn, *args),
                   "plain_ms": kernel_ms(plain, *args),
                   "library_ms": None,
                   "library": "none: no one PyTorch call computes it",
                   "copy_ms": kernel_ms(torch.clone, got)}
            rec["bound_ms"], rec["bound_by"] = bound(
                float(ops), nbytes(*args, got), PEAK_F32_FLOPS)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            if not rec["bit_for_bit"]:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {rec}")
            recs.setdefault(name, []).append(rec)


# K6, K7 and K8 on f32 rows: (kernel, case, shape), the DiT's rows and the
# unfused w8a8 layers' inputs, tie rows, and the 32 x 128 DiT's widths
F32_GLUE_CASES = (
    [("quant_rows", label, shape) for label, shape in (
        ("x_embedder", (1, 4096, 64)), ("context_embedder", (1, 512, 4096)),
        ("time in", (1, 256)), ("pooled in", (1, 768)),
        ("mods pass", (4, 3072)))]
    + [case for n_rows in (4096, 512, 4608) for case in (
        ("quant_rows", f"attention, {n_rows} rows", (1, n_rows, 3072)),
        ("gelu_quant", f"{n_rows} rows", (1, n_rows, 12288)),
        ("ln_mod_quant", f"{n_rows} rows", (1, n_rows, 3072)))]
    + [("ln_mod_quant", "batch 2", (2, 512, 3072)),
       ("quant_rows", "tie rows", (1, 256, 12288)),
       ("quant_rows", "tie rows", (64, 3072)),
       ("quant_rows", "width 4096, 4608 rows", (1, 4608, 4096)),
       ("gelu_quant", "width 16384, 4608 rows", (1, 4608, 16384)),
       ("ln_mod_quant", "width 4096, 4608 rows", (1, 4608, 4096))])
# the case of each whose plain version is timed too (the kernels line's)
F32_GLUE_MAIN = {"quant_rows": "attention, 4608 rows",
                 "gelu_quant": "4608 rows", "ln_mod_quant": "4096 rows"}


def check_f32_quant_glue(g, recs):
    """K6, K7 and K8 on f32 rows (the f32 w8a8 and w4a8 DiT's fused glue)
    at ``F32_GLUE_CASES``, rows whose scale spans four decades (K7's
    centred): K8 bit for bit its plain version, tie rows included; K6 and
    K7 codes within one step, at most 0.1% of them flipped, and scales
    within 1e-5 relative (f32 row statistics summed in another order; K7's
    exp form of the tanh against PyTorch's tanhf); K6 bit for bit K8 after
    K5 on f32 rows at every width (K5's group and order of sums are K6's:
    one LayerNorm + modulate in both). Each counts one
    launch under its ``_f32`` name; timed beside the bound (bytes: the
    f32 rows and modulation rows read once, the codes and scales written
    once) and, at ``F32_GLUE_MAIN``'s cases, the plain version. No one
    PyTorch call computes them."""
    import torch
    from x2i_torch.ops import fused_glue as fg

    dev = torch.device("cuda")

    def rows32(*shape, mean=3.0):
        lead = (*shape[:-1], 1)
        sigma = 10.0 ** torch.empty(lead, device=dev).uniform_(
            -2.0, 2.0, generator=g)
        mu = sigma * mean * torch.randn(lead, generator=g, device=dev)
        return torch.randn(shape, generator=g, device=dev) * sigma + mu

    ops = {"ln_mod_quant": 16, "gelu_quant": 20, "quant_rows": 5}
    for name, label, shape in F32_GLUE_CASES:
        if label == "tie rows":
            x = tie_rows(g, math.prod(shape[:-1]), shape[-1],
                         torch.float32).view(shape)
        else:
            x = rows32(*shape, mean=0.0 if name == "gelu_quant" else 3.0)
        inputs = (x,)
        if name == "ln_mod_quant":
            mod = 0.5 * torch.randn((shape[0], 6 * shape[-1]), generator=g,
                                    device=dev)
            inputs = (x, mod[:, :shape[-1]], mod[:, shape[-1]:2 * shape[-1]])
        fn, plain = getattr(fg, name), getattr(fg, name + "_plain")
        key = name + "_f32"
        before = dict(fg.LAUNCHES)
        q, a = fn(*inputs)
        counted = fg.LAUNCHES == dict(before, **{key: before[key] + 1})
        qp, ap = plain(*inputs)
        torch.cuda.synchronize()
        d = (q.int() - qp.int()).abs()
        scale_rel = ((a - ap).abs() / ap).max().item()
        rec = {"phase": "kernels", "kernel": key, "case": label,
               "shape": list(x.shape), "dtype": "float32",
               "instance": list(fg.f32_instance(shape[-1])),
               "max_abs_err": (q.float() * a - qp.float() * ap).abs().max()
               .item(),
               "max_code_diff": int(d.max()), "codes_flipped": int(
                   (d != 0).sum()), "codes": d.numel(),
               "max_scale_rel_err": scale_rel, "counted_once": counted,
               "bit_for_bit": torch.equal(q, qp) and torch.equal(a, ap),
               "ms": kernel_ms(fn, *inputs),
               "plain_ms": (kernel_ms(plain, *inputs)
                            if F32_GLUE_MAIN[name] == label else None),
               "library_ms": None,
               "library": "none: no one PyTorch call computes it"}
        rec["bound_ms"], rec["bound_by"] = bound(
            ops[name] * x.numel(), nbytes(*inputs, q, a), PEAK_F32_FLOPS)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["gb_per_s"] = nbytes(*inputs, q, a) / rec["ms"] / 1e6
        flips = rec["codes_flipped"] / rec["codes"]
        ok = counted and (rec["bit_for_bit"] if name == "quant_rows" else
                          rec["max_code_diff"] <= 1 and flips <= 1e-3
                          and scale_rel <= 1e-5)
        if name == "ln_mod_quant":
            q8, a8 = fg.quant_rows(fg.ln_mod(*inputs))
            rec["k8_after_k5_exact"] = (torch.equal(q, q8)
                                        and torch.equal(a, a8))
            ok = ok and rec["k8_after_k5_exact"]
        emit(rec)
        if not ok:
            raise AssertionError(f"{key} disagrees with its plain version "
                                 f"or was not counted once: {rec}")
        recs.setdefault(key, []).append(rec)


def check_f32_gemms(g, rows, recs):
    """The f32 epilogue of the int8 and the w4a8 GEMM (an f32 layer's
    output, bias and addend) at the twelve DiT shapes of ``GEMM_SHAPES``,
    with the bias and the addend where the DiT's layers have them, on
    weights from ``quantize_kernel`` and ``quantize_kernel_w4a8`` and
    activation codes of f32 rows: bit for bit the plain version (every
    step rounded once in f32 in its order; the int32 sums are exact), one
    launch counted under ``int8_gemm_f32`` / ``w4a8_gemm_f32``. Timed at
    every shape; at ``GEMM_MAIN`` also the plain version, ``torch._int_mm``
    (the int32 product alone) and the bf16 epilogue on the same codes
    (``bf16_out_ms``: what the f32 output's bytes cost)."""
    import torch
    from x2i_torch.ops import fused_glue as fg
    from x2i_torch.ops import int4_gemm as i4
    from x2i_torch.ops import int8_gemm as ig
    from x2i_torch.ops.quant import quantize_kernel, quantize_kernel_w4a8

    dev = torch.device("cuda")
    f32 = torch.float32
    for kernel in ("int8_gemm", "w4a8_gemm"):
        for label, m, k, n, width, k0, with_add, with_bias in GEMM_SHAPES:
            width = width or k
            wf = torch.randn((n, width), generator=g, device=dev) / width ** 0.5
            if kernel == "int8_gemm":
                q, scale = quantize_kernel(wf.t())
                w, extra_w = q.t().contiguous(), ()
                fn, plain = ig.int8_linear, ig.int8_linear_plain
                weight_bytes = n * k
            else:
                pk, ms, scale = quantize_kernel_w4a8(wf.t())
                w, extra_w = pk.t().contiguous(), (ms,)
                fn, plain = i4.w4a8_linear, i4.w4a8_linear_plain
                weight_bytes = n * k // 2 + n * (k // (width // ms.shape[0]))
            del wf
            xq, a = fg.quant_rows_plain(rows(m, k).float())
            bias = (0.1 * torch.randn(n, generator=g, device=dev)
                    if with_bias else None)
            add = (torch.randn((m, n), generator=g, device=dev)
                   if with_add else None)

            def kern(x, s, *d, b=bias, out=f32):
                return fn(x, s, w, *extra_w, scale, b, k0,
                          d[0] if d else None, out_dtype=out)

            def ref(x, s, *d):
                return plain(x, s, w, *extra_w, scale, bias, k0,
                             d[0] if d else None, out_dtype=f32)

            extra = (add,) if with_add else ()
            key = kernel + "_f32"
            before = ig.GEMM.launches[key]
            got, want = kern(xq, a, *extra), ref(xq, a, *extra)
            counted = ig.GEMM.launches[key] == before + 1
            torch.cuda.synchronize()
            rec = {"phase": "kernels", "kernel": key, "case": label,
                   "shape": [m, k, n], "k0": k0, "dtype": "float32",
                   "bias": with_bias, "addend": with_add,
                   "bit_for_bit": torch.equal(got, want),
                   "out_dtype": str(got.dtype), "counted_once": counted,
                   "max_abs_err": (got - want).abs().max().item(),
                   "ms": kernel_ms(kern, xq, a, *extra),
                   "plain_ms": None, "library_ms": None,
                   "library": "torch._int_mm (int32 product only)"
                   if kernel == "int8_gemm" else
                   "none: no one PyTorch call computes it"}
            if label == GEMM_MAIN:
                rec["plain_ms"] = kernel_ms(ref, xq, a, *extra)
                b16 = None if bias is None else bias.to(torch.bfloat16)
                rec["bf16_out_ms"] = kernel_ms(
                    lambda *t: kern(*t, b=b16, out=torch.bfloat16), xq, a,
                    *(t.to(torch.bfloat16) for t in extra))
                if kernel == "int8_gemm":
                    w_k = w[:, k0:k0 + k].contiguous()
                    rec["library_ms"] = kernel_ms(torch._int_mm, xq, w_k.t())
            rec["bound_ms"], rec["bound_by"] = bound(
                2.0 * m * n * k,
                nbytes(xq, a, scale, bias, add, got) + weight_bytes,
                PEAK_INT8_OPS)
            rec["tops"] = 2.0 * m * n * k / rec["ms"] / 1e9
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            if not (rec["bit_for_bit"] and counted
                    and got.dtype == torch.float32):
                raise AssertionError(f"{key} disagrees with its plain "
                                     f"version: {rec}")
            recs.setdefault(key, []).append(rec)


def check_f32_dequant(g, recs):
    """The f32 instances of the int8 and the w4 dequantize kernels (the
    f32 w8 and w4 DiT's weights) at the DiT's weight shapes
    (``DEQUANT_SHAPES``), on weights from ``quantize_kernel`` and
    ``quantize_kernel_w4``: bit for bit ``dequant_weight_plain(...,
    torch.float32)`` (f32(code) times the f32 scale, rounded once), one
    launch counted under ``int8_dequant_f32`` / ``w4_dequant_f32``;
    timed at every shape beside the bound (bytes: the codes and scales
    read once, the f32 weight written once) and, at ``DEQUANT_MAIN``, the
    plain version and a ``torch.clone`` of the weight (the rate the card
    reaches on the bytes it writes). No one PyTorch call computes them."""
    import torch
    from x2i_torch.ops import int4_gemm as i4
    from x2i_torch.ops import int8_gemm as ig
    from x2i_torch.ops.quant import quantize_kernel, quantize_kernel_w4

    dev = torch.device("cuda")
    f32 = torch.float32
    for label, n, inn in DEQUANT_SHAPES:
        wf = torch.randn((n, inn), generator=g, device=dev) / inn ** 0.5
        q, s8 = quantize_kernel(wf.t())
        pk, s4 = quantize_kernel_w4(wf.t())
        del wf
        for key, fn, args, mode in (
                ("int8_dequant_f32", ig.int8_dequant,
                 (q.t().contiguous(), s8), "w8"),
                ("w4_dequant_f32", i4.w4_dequant, (pk.t().contiguous(), s4),
                 "w4")):
            before = ig.GEMM.launches[key]
            got = fn(*args, f32)
            counted = ig.GEMM.launches[key] == before + 1
            want = i4.dequant_weight_plain(*args, mode, f32)
            torch.cuda.synchronize()
            rec = {"phase": "kernels", "kernel": key, "case": label,
                   "shape": [n, inn], "dtype": "float32",
                   "bit_for_bit": torch.equal(got, want),
                   "out_dtype": str(got.dtype), "counted_once": counted,
                   "max_abs_err": (got - want).abs().max().item(),
                   "ms": kernel_ms(lambda *t: fn(*t, f32), *args),
                   "plain_ms": None, "library_ms": None,
                   "library": "none: no one PyTorch call computes it"}
            if label == DEQUANT_MAIN:
                rec["plain_ms"] = kernel_ms(
                    lambda *t: i4.dequant_weight_plain(*t, mode, f32), *args)
                rec["copy_ms"] = kernel_ms(torch.clone, got)
            rec["bound_ms"], rec["bound_by"] = bound(
                float(n * inn), nbytes(*args, got), PEAK_F32_FLOPS)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            if not (rec["bit_for_bit"] and counted
                    and got.dtype == torch.float32):
                raise AssertionError(f"{key} disagrees with its plain "
                                     f"version: {rec}")
            recs.setdefault(key, []).append(rec)


# one QuantLinear's straight-through dx: rows, in, out (the single
# block's mlp_in at 64 tokens)
STE_SHAPE = (64, 3072, 12288)
# the launches of its forward and backward on the card, per mode
STE_LAUNCHES = {
    "w8a8": dict(quant_rows=1, int8_gemm=1, int8_dequant=1),
    "w8": dict(dequant_gemm=1, int8_dequant=1),
    "w4": dict(dequant_gemm=1, w4_dequant=1),
    "w4a8": dict(quant_rows=1, w4a8_gemm=1, w4a8_dequant=1)}


def check_straight_through(g):
    """One bf16 ``QuantLinear`` per mode (``STE_SHAPE``) on the card: the
    forward and the straight-through backward of ``dy`` through the
    kernels (the counts exact), its dx against the same layer's on the
    CPU (the plain quantization, product, dequantize and matmul): the
    same bf16 weight and dy, f32 sums in cuBLAS's order and the CPU's, so
    within one bf16 step at the largest magnitude (2^-7 of max |dx|)."""
    import copy

    import torch
    from torch import nn
    from x2i_torch.ops.quant import QuantLinear

    dev, bf = torch.device("cuda"), torch.bfloat16
    rows_n, inn, out = STE_SHAPE
    lin = nn.Linear(inn, out, dtype=bf, device=dev)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((out, inn), generator=g, device=dev)
                         / inn ** 0.5)
    x = torch.randn((rows_n, inn), generator=g, device=dev).to(bf)
    dy = torch.randn((rows_n, out), generator=g, device=dev).to(bf)
    for mode, launched in STE_LAUNCHES.items():
        want_used = dict(NO_LAUNCHES, **launched)
        layer = QuantLinear.from_linear(lin, mode)
        cpu_layer = copy.deepcopy(layer).cpu()
        xg = x.clone().requires_grad_()
        reset_counts()
        layer(xg).backward(dy)
        torch.cuda.synchronize()
        used = launch_counts()
        xc = x.cpu().requires_grad_()
        cpu_layer(xc).backward(dy.cpu())
        got, want = xg.grad.float().cpu(), xc.grad.float()
        rec = {"phase": "kernels", "check": "straight-through dx",
               "mode": mode, "shape": list(STE_SHAPE),
               "max_abs_err": (got - want).abs().max().item(),
               "bar": 2.0 ** -7 * want.abs().max().item(),
               "rel_l2_err": ((got - want).norm() / want.norm()).item(),
               "finite": bool(torch.isfinite(got).all()),
               "launches": used, "launches_expected": want_used}
        emit(rec)
        if not (rec["finite"] and rec["max_abs_err"] <= rec["bar"]
                and used == want_used):
            raise AssertionError(f"the {mode} straight-through dx on the "
                                 f"card disagrees with the CPU's: {rec}")


# ----------------------------------------------------------- text2image

MODEL = "x2i-internvl2.5-1b"
PROMPTS = ("a red fox in fresh snow", "a lighthouse at dusk",
           "a bowl of ramen", "a sailboat on a calm lake")


def build_pipeline(seed: int):
    """The full-width x2i-internvl2.5-1b text path in bf16, weights drawn
    on the card from one torch.Generator (Dense std 1/sqrt(fan_in), norm
    scales 1, biases 0): -> (its LM, the pipeline, the generator state
    the DiT was drawn from, for ``draw_dit``). Prompts map to 40 token ids
    drawn from a seed derived from the text, right-padded to 512 with the
    mask."""
    import dataclasses
    import zlib

    import numpy as np
    import torch
    from x2i_torch.core.config import MODEL_REGISTRY, GenerationConfig
    from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.models.proj import Proj
    from x2i_torch.models.qwen2 import Qwen2LM
    from x2i_torch.models.vae import AutoencoderKL
    from x2i_torch.params import random_init_
    from x2i_torch.pipeline import (X2IPipeline, lm_text_encoder,
                                    resolve_device)

    dev = resolve_device()
    spec = MODEL_REGISTRY[MODEL]
    gen = torch.Generator(device=dev).manual_seed(seed)
    vocab, seq, real = spec.llm.vocab_size, 512, 40

    def tokenize(text: str):
        rng = np.random.default_rng([seed, zlib.crc32(text.encode())])
        ids = np.zeros(seq, np.int64)
        ids[:real] = rng.integers(0, vocab, real)
        return ids, np.arange(seq) < real

    lm = random_init_(Qwen2LM(spec.llm, dev), gen)
    encoder_fn, encoder_batch_fn = lm_text_encoder(lm, tokenize)
    proj = random_init_(Proj(spec.proj, dev), gen)
    dit_state = gen.get_state()
    flux, after = draw_dit(dit_state)
    gen.set_state(after)
    return lm, X2IPipeline(
        encoder_fn=encoder_fn,
        proj=proj,
        flux=flux,
        vae=random_init_(AutoencoderKL(spec.vae, dev), gen),
        scheduler=FlowMatchEulerScheduler(spec.scheduler),
        gen_cfg=GenerationConfig(height=1024, width=1024,
                                 num_inference_steps=4),
        encoder_batch_fn=encoder_batch_fn), dit_state


def draw_dit(state):
    """The serving DiT (full width, bf16, fused glue) with weights drawn
    from a generator in ``state`` (the same weights from the same state)
    -> (the DiT, the generator's state after the draw)."""
    import dataclasses

    import torch
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.params import random_init_

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.set_state(state)
    cfg = dataclasses.replace(MODEL_REGISTRY[MODEL].flux, fused_glue=True)
    return random_init_(FluxTransformer2D(cfg, dev), gen), gen.get_state()


def _cuda_libraries():
    from x2i_torch.ops.flash_attention import (KERNEL, KERNEL_BWD,
                                               KERNEL_CHUNKED)
    from x2i_torch.ops.fused_glue import ROW_GLUE
    from x2i_torch.ops.int8_gemm import GEMM
    return KERNEL, KERNEL_CHUNKED, KERNEL_BWD, GEMM, ROW_GLUE


def launch_counts():
    from x2i_torch.ops import fused_glue as fg
    counts = dict(fg.LAUNCHES)
    for lib in _cuda_libraries():
        counts.update(lib.launches)
    return counts


def reset_counts():
    from x2i_torch.ops import fused_glue as fg
    for lib in _cuda_libraries():
        lib.reset_launches()
    fg.reset_launches()


NO_LAUNCHES = {"flash_fwd_rope": 0, "flash_fwd": 0, "flash_fwd_pipe": 0,
               "flash_fwd_lse": 0, "flash_fwd_f32": 0,
               "flash_fwd_lse_f32": 0, "flash_chunked": 0,
               "flash_chunked_f32": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
               "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0,
               "flash_fwd_rope_f32": 0, "flash_fwd_rope_d256": 0,
               "flash_fwd_d256": 0, "flash_fwd_pipe_d256": 0,
               "flash_fwd_f32_d256": 0, "flash_fwd_rope_f32_d256": 0,
               "flash_chunked_d256": 0, "flash_chunked_f32_d256": 0,
               "flash_fwd_lse_d256": 0, "flash_fwd_lse_f32_d256": 0,
               "flash_bwd_dq_d256": 0, "flash_bwd_dkv_d256": 0,
               "flash_bwd_dq_f32_d256": 0, "flash_bwd_dkv_f32_d256": 0,
               "ln_mod": 0, "ln_mod_f32": 0, "ln_mod_quant": 0,
               "gelu_quant": 0, "quant_rows": 0, "row_absmax": 0,
               "quant_rows_at": 0, "int8_gemm": 0, "int8_gemm_acc": 0,
               "w4a8_gemm": 0, "w4a8_gemm_acc": 0, "dequant_gemm": 0,
               "w4_dequant": 0, "int8_dequant": 0, "w4a8_dequant": 0,
               "ln_mod_quant_f32": 0, "gelu_quant_f32": 0,
               "quant_rows_f32": 0, "int8_gemm_f32": 0, "w4a8_gemm_f32": 0,
               "int8_dequant_f32": 0, "w4_dequant_f32": 0}


def expected_launches(quantized, steps: int, n2: int = 19, n1: int = 38,
                      mods_pass: bool = True, joint_tokens: int = 4608,
                      lm_layers: int = 24, rope_layout: str = "half",
                      dtype: str = "bf16", head_dim: int = 128,
                      f32_fused: bool = False):
    """Kernel launches of one image (``steps`` DiT steps, n2 double and n1
    single blocks, the adaLN rows in one pass first, an LM of
    ``lm_layers``) or, with ``mods_pass=False`` and the LM's count left
    out, of one DiT call that computes its mods inline. Above 8192 joint
    tokens the DiT's attention is K2 (norm and rope outside), else K1a, or
    in the interleaved rope layout K1c (norm and rope outside).
    w4 and w8 launch the dequantizing GEMM once per dense call; w4a8
    counts w8a8's products on its GEMM. ``dtype="f32"``: an f32 DiT (the
    LM stays bf16), its attention in the f32 instances (K2's above 8192
    joint tokens, else K1's rope-and-norm instance), its kernels the f32
    instances (counted as ``_f32``: w8 and w4 the f32 dequantize kernel
    once per dense call, before ``F.linear``), its glue unfused (no K5;
    in w8a8 and w4a8 one K8 a dense call) or with ``f32_fused`` K5-K8's
    f32 instances as the bf16 DiT's. ``head_dim=256``: the 12 x 256 DiT,
    whose attention counts under its ``_d256`` names (on the pad route
    too: K1's rope variant, the masked body)."""
    lm = lm_layers if mods_pass else 0    # one K1b per LM layer
    want = dict(NO_LAUNCHES, flash_fwd=lm)
    d256 = "_d256" if head_dim == 256 else ""
    f32 = dtype == "f32"
    fused = not f32 or f32_fused
    sfx = "_f32" if f32 else ""
    if f32:
        dit = ("flash_chunked_f32" if joint_tokens > 8192 else
               "flash_fwd_f32" if rope_layout == "interleaved" else
               "flash_fwd_rope_f32")
    else:
        dit = ("flash_chunked" if joint_tokens > 8192 else "flash_fwd_pipe"
               if rope_layout == "interleaved" else "flash_fwd_rope")
    want[dit + d256] = (n2 + n1) * steps
    # the adaLN mod layers (2 per double block, 1 per single): once per
    # image over all steps' rows, with the time and pooled embedders' 4
    # layers run again for those rows, or inline in each call
    mods = 2 * n2 + n1
    per_step_mods = 0 if mods_pass else mods
    once = mods + 4 if mods_pass else 0
    # per step 12 dense calls per double block, 5 per single (q, k, v,
    # mlp_in, out), the 7 unfused layers and proj_out
    dense = (12 * n2 + 5 * n1 + 8 + per_step_mods) * steps + once
    if quantized not in ("w8a8", "w4a8"):
        # per step 4 per double block, 1 per single block, 1 for the head
        if fused:
            want["ln_mod" + sfx] = (4 * n2 + n1 + 1) * steps
        if quantized in ("w4", "w8"):
            want["dequant_gemm" if not f32 else "int8_dequant_f32"
                 if quantized == "w8" else "w4_dequant_f32"] = dense
        return want
    gemm = ("w4a8_gemm" if quantized == "w4a8" else "int8_gemm") + sfx
    if not fused:
        # one K8 and one product a dense call (the single block's out
        # layer takes its concatenated input whole)
        want.update({"quant_rows" + sfx: dense, gemm: dense})
        return want
    want.update({
        "ln_mod_quant" + sfx: (4 * n2 + n1 + 1) * steps,
        "gelu_quant" + sfx: (2 * n2 + n1) * steps,
        # per step the attention outputs (2 per double, 1 per single) and
        # the 7 layers fed unfused: x_embedder, context_embedder, time
        # in/out, pooled in/out, norm_out
        "quant_rows" + sfx: (2 * n2 + n1 + 7 + per_step_mods) * steps + once,
        # per step 12 per double block, 6 per single (q, k, v, mlp_in and
        # the two chunks of out), 7 unfused layers and proj_out
        gemm: (12 * n2 + 6 * n1 + 8 + per_step_mods) * steps + once})
    return want


def check_routes(seed: int, px: int = 512,
                 label: str = "text2image-reference", bank=None,
                 rope_layout: str = "half", dtype: str = "bf16",
                 head_dim: int = 128, f32_fused: bool = False,
                 wide: bool = False):
    """Agreement with a reference on a small input: a full-width DiT cut to
    2 double + 2 single blocks, one step at px^2 (512^2: 1024 image + 512
    text tokens; 1536^2: 9216 + 512, above 8192, where the attention is
    K2), through the kernels (fused glue, K1 or K2, and K5) and through
    the plain route (unfused glue, plain attention) on the same bf16
    weights. The two round at different points (the plain route keeps p
    in f32; K1 rounds q/k once after norm, rope and scale), so they agree
    to bf16 accuracy, not bit for bit: relative L2 error at most 2e-2.
    ``bank``: LightControl's branches on a px^2 guidance image drawn from
    the seed give both routes the same controls (its first two rows).
    ``rope_layout="interleaved"``: both in that layout (the kernel route
    K1c, the qk norm and the rotation outside it). ``dtype="f32"``: both
    DiTs in f32 with the glue unfused (the f32 DiT's serving config), the
    kernel route the f32 instances (K1's, or above 8192 tokens K2's), held
    to the same bar: the f32 instances round their operands to bf16 where
    the bf16 kernels do, and everything else is f32; with ``f32_fused``
    the f32 kernel DiT's glue fused (K5's f32 instance, the qk norm inside
    K1's rope-and-norm instance). ``head_dim=256``: both DiTs 12 heads x
    256 (``D256``), the kernel route K1 or K2 at D = 256 (at 960^2's
    4112 tokens or 480^2's 1412, the pad route). ``wide``: both 32 heads
    x 128 (``W4096``: K5's f32 instance at 4096)."""
    import dataclasses

    import torch
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.params import random_init_

    dev = torch.device("cuda")
    f32 = dtype == "f32"
    base = dataclasses.replace(MODEL_REGISTRY[MODEL].flux, num_layers=2,
                               num_single_layers=2, rope_layout=rope_layout,
                               **({"dtype": torch.float32} if f32 else {}),
                               **(D256 if head_dim == 256 else {}),
                               **(W4096 if wide else {}))
    g = torch.Generator(device=dev).manual_seed(seed)
    kern = random_init_(FluxTransformer2D(
        dataclasses.replace(base, fused_glue=not f32 or f32_fused), dev), g)
    plain = FluxTransformer2D(dataclasses.replace(base,
                                                  attention_impl="plain"), dev)
    plain.load_state_dict(kern.state_dict())

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    s_img = (px // 16) ** 2
    args = (rnd(1, s_img, 64), rnd(1, 512, 4096), rnd(1, 768),
            torch.full((1,), 0.75, device=dev),
            prepare_latent_image_ids(px // 8, px // 8, dev),
            torch.zeros((512, 3), device=dev))
    kw = {}
    if bank is not None:
        guide = torch.rand((1, px, px, 3), generator=g, device=dev) * 2 - 1
        with torch.inference_mode():
            kw["controls"] = bank(guide, args[3] * 1000.0)[:2]
    before = launch_counts()
    with torch.inference_mode():
        got = kern(*args, **kw).float()
        used = {k: v - before[k] for k, v in launch_counts().items()}
        want = plain(*args, **kw).float()
    rel = ((got - want).norm() / want.norm()).item()
    rec = {"phase": label, "blocks": [2, 2], "controls": bank is not None,
           "rope_layout": rope_layout, "dtype": dtype, "head_dim": head_dim,
           "width": kern.cfg.num_attention_heads * kern.cfg.attention_head_dim,
           "fused_glue": kern.cfg.fused_glue,
           "tokens": [s_img, 512], "rel_l2_err": rel,
           "max_abs_err": (got - want).abs().max().item(),
           "finite": bool(torch.isfinite(got).all()),
           "kernel_launches": used}
    emit(rec)
    want_used = expected_launches(False, 1, 2, 2, mods_pass=False,
                                  joint_tokens=s_img + 512,
                                  rope_layout=rope_layout, dtype=dtype,
                                  head_dim=head_dim, f32_fused=f32_fused)
    if not (rec["finite"] and rel <= 2e-2 and used == want_used):
        raise AssertionError(f"kernel route disagrees with the plain route: "
                             f"{rec}")
    return used


def check_routes_quant(seed: int, mode: str = "w8a8", dtype: str = "bf16",
                       wide: bool = False):
    """The same 2 + 2-block full-width DiT, one step at 512^2, in a
    quantized mode: the kernel route (fused glue, K1a, and in w8a8 K6/K7/K8
    with the int8 GEMM, in w4a8 the same glue with the w4a8 GEMM, in w4 K5
    with the dequantize kernel) against the plain route (unfused glue,
    plain quantization and product, plain attention) on the same
    quantized weights, held to the JAX package's bar for two w8a8
    evaluations (tests/test_fused_glue.py): correlation above 0.999 and
    relative L2 error below 5e-2. ``dtype="f32"``: both DiTs in f32, the
    kernel route the f32 instances (K1's rope-and-norm, K5-K8's, the GEMMs'
    f32 epilogue, in w8 and w4 the f32 dequantize kernel before
    ``F.linear``); ``wide``: both 32 heads x 128 (``W4096``: K5-K8 at
    4096 and 16384). -> the kernel route's launch counts."""
    import dataclasses

    import torch
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.params import random_init_

    dev = torch.device("cuda")
    base = dataclasses.replace(MODEL_REGISTRY[MODEL].flux, num_layers=2,
                               num_single_layers=2, quantized=mode,
                               **({"dtype": torch.float32}
                                  if dtype == "f32" else {}),
                               **(W4096 if wide else {}))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    kern = random_init_(FluxTransformer2D(
        dataclasses.replace(base, fused_glue=True), dev), g)
    plain = FluxTransformer2D(dataclasses.replace(
        base, attention_impl="plain", quant_impl="plain"), dev)
    plain.load_state_dict(kern.state_dict())

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    args = (rnd(1, 1024, 64), rnd(1, 512, 4096), rnd(1, 768),
            torch.full((1,), 0.75, device=dev),
            prepare_latent_image_ids(64, 64, dev),
            torch.zeros((512, 3), device=dev))
    with torch.inference_mode():
        reset_counts()
        got = kern(*args).float()
        used = launch_counts()
        reset_counts()
        want = plain(*args).float()
        used_plain = launch_counts()
    rel = ((got - want).norm() / want.norm()).item()
    corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()])
                          )[0, 1].item()
    want_used = expected_launches(mode, 1, 2, 2, mods_pass=False,
                                  dtype=dtype, f32_fused=True)
    label = mode if dtype == "bf16" else f"f32-{mode}"
    rec = {"phase": f"{label}{'-4096' if wide else ''}-reference",
           "blocks": [2, 2], "dtype": dtype,
           "width": kern.cfg.num_attention_heads * kern.cfg.attention_head_dim,
           "tokens": [1024, 512], "rel_l2_err": rel, "corr": corr,
           "max_abs_err": (got - want).abs().max().item(),
           "finite": bool(torch.isfinite(got).all()),
           "kernel_launches": used, "kernel_launches_expected": want_used,
           "plain_route_launches": used_plain}
    emit(rec)
    if not (rec["finite"] and corr > 0.999 and rel < 5e-2
            and used == want_used
            and not any(used_plain.values())):
        raise AssertionError(f"{mode} kernel route disagrees with the plain "
                             f"route: {rec}")
    return used


def run_image(pipe, seed: int, label: str, want: dict, px: int = 1024,
              steps: int = 4, model: str = MODEL, request=None,
              control_pixels=None):
    """One warm-up image, then the main path: one px^2 image of ``steps``
    steps with every launch count set to 0 just before and read just
    after; then the layer times and the pre-postprocess pixels of the same
    image. Above ``vae_tile_px`` the decode timed is the tiled one, as on
    the path. ``request``: the ``run_task`` request (task, prompt, images,
    video), by default text2image of the first prompt; the encoder's
    time (``lm_prefill_ms``) is then the whole encoder's, host half and
    vision tower included. ``control_pixels``: LightControl's guidance
    image, for a pipeline ``with_controls`` (``dit_step_ms`` stays the
    DiT's alone)."""
    import torch
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids

    req = request or {"task": "text2image", "prompt": PROMPTS[0]}
    size = dict(height=px, width=px, num_steps=steps)
    if control_pixels is not None:
        size["control_pixels"] = control_pixels
    t0 = time.perf_counter()
    pipe.run_task(**req, seed=seed, **size)               # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img = pipe.run_task(**req, seed=seed, **size)         # the main path
    sec = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # per-layer times and the pre-postprocess pixels, after the counts
    dev, dt = pipe.device, torch.bfloat16
    with torch.inference_mode():
        pooled, emb = pipe.encode(req)
        prefill_ms = call_ms(lambda: pipe.encoder_fn(req), iters=5)
        g = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn((1, (px // 16) ** 2, 64), generator=g,
                            device=dev, dtype=dt)
        pixels = pipe._generate(noise, emb, pooled, px, px, steps,
                                control_pixels)
        sig = pipe.scheduler.inference_sigmas(
            steps, image_seq_len=(px // 16) ** 2, device=dev)
        img_ids = prepare_latent_image_ids(px // 8, px // 8, dev)
        txt_ids = torch.zeros((emb.shape[1], 3), device=dev)
        guide = (torch.full((1,), pipe.gen_cfg.guidance_scale, device=dev)
                 if pipe.flux.cfg.guidance_embeds else None)
        mods = pipe.flux(noise, emb, pooled, sig[:-1], img_ids, txt_ids,
                         guidance=guide, mods_only=True)
        step_mods = {k: v[0] for k, v in mods.items()}
        dit_ms = call_ms(lambda: pipe.flux(noise, emb, pooled,
                                           sig[:1].expand(1), img_ids,
                                           txt_ids, guidance=guide,
                                           precomputed_mods=step_mods),
                         iters=3)
        lat = torch.randn((1, px // 8, px // 8, 16), generator=g,
                          device=dev, dtype=dt)
        tiled = px > pipe.gen_cfg.vae_tile_px
        decode = pipe.vae.decode_tiled if tiled else pipe.vae.decode
        vae_ms = call_ms(lambda: decode(lat), iters=3)
    finite = bool(torch.isfinite(pixels).all())
    std = pixels.float().std().item()
    dit_bytes = sum(t.numel() * t.element_size() for t in
                    (*pipe.flux.parameters(), *pipe.flux.buffers()))
    rec = {"phase": label, "model": model, "px": px, "steps": steps,
           "task": req["task"], "quantized": pipe.flux.cfg.quantized,
           "image_shape": list(img.shape), "image_dtype": str(img.dtype),
           "pixels_finite": finite, "pixels_std": std,
           "s_per_image": sec, "warmup_s": warm_s,
           "lm_prefill_ms": prefill_ms, "dit_step_ms": dit_ms,
           "vae_decode_ms": vae_ms, "vae_decode_tiled": tiled,
           "joint_tokens": emb.shape[1] + (px // 16) ** 2,
           "max_memory_allocated": peak,
           "dit_weight_bytes": dit_bytes,
           "launches": counts, "launches_expected": want}
    if (tuple(img.shape) != (1, px, px, 3) or str(img.dtype) != "uint8"
            or not finite or not std > 0 or float(img.std()) == 0.0):
        emit(rec)
        raise AssertionError(f"{label} output is wrong: {rec}")
    return rec, pixels, counts


def phase_text2image(seed: int):
    import torch

    t0 = time.perf_counter()
    lm, pipe, dit_state = build_pipeline(seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want = expected_launches(False, 4)
    rec, pixels, counts = run_image(pipe, seed, "text2image", want)
    rec["build_s"] = build_s
    emit(rec)
    if counts != want:
        raise AssertionError(f"main path missed its kernels: {counts} "
                             f"!= {want}")
    check_routes(seed)
    return pipe, lm, counts, pixels, dit_state


def phase_interleaved(pipe, bf16_pixels, seed: int, card: str):
    """The interleaved rope layout on phase 3's full-depth bf16 DiT with
    its fused glue: its q/k channels and qk-norm scales permuted back in
    place to the checkpoints' interleaved order (``set_rope_layout_``),
    the same 1024^2 image with exact launch counts (K1c 228: the qk norm
    and the rotation before a kernel without rope; K1a 0; K5 460), its
    pixels within 2e-2 relative L2 of the half layout's and its levels'
    max and mean difference; permuted back, every moved tensor bit for bit
    as before; then a 2 + 2-block full-width interleaved DiT holds its
    kernel route against its plain route. -> the image's launch counts."""
    import torch
    from x2i_torch.models.flux import QK_LINEARS, QK_NORMS, set_rope_layout_
    from x2i_torch.models.vae import postprocess

    flux = pipe.flux
    names = set(QK_LINEARS) | set(QK_NORMS)
    before = {k: v.clone() for k, v in flux.state_dict().items()
              if k.split(".")[-2] in names}
    set_rope_layout_(flux, "interleaved")
    want = expected_launches(False, 4, rope_layout="interleaved")
    try:
        rec, pixels, counts = run_image(pipe, seed, "interleaved", want)
    finally:
        set_rope_layout_(flux, "half")
    state = flux.state_dict()
    moved = [k for k, v in before.items() if not torch.equal(state[k], v)]
    got, ref = pixels.float(), bf16_pixels.float()
    levels = (postprocess(pixels).int() - postprocess(bf16_pixels).int()
              ).abs().float()
    rec.update(card=card, rel_l2_vs_half=((got - ref).norm() / ref.norm())
               .item(), level_diff_max=levels.max().item(),
               level_diff_mean=levels.mean().item(),
               qk_tensors_permuted=len(before), restored=not moved)
    emit(rec)
    del before, state
    if not (counts == want and rec["rel_l2_vs_half"] <= 2e-2 and not moved
            and flux.cfg.rope_layout == "half"):
        raise AssertionError(f"the interleaved image is wrong: {rec}")
    check_routes(seed, label="interleaved-reference",
                 rope_layout="interleaved")
    return counts


TPROJ = dict(d_model=896, n_heads=14, out_dim1=768, out_dim2=4096,
             num_layers=3, ffn_dim=2048)   # Transformer_proj at 0.5B widths
TPROJ_REL_L2 = 1e-2          # K1's f32 instance rounds q, k, v to bf16


def phase_proj_variants(pipe, seed: int, card: str):
    """The proj's variants at the internvl1b proj's widths over the 0.5B
    LM's 512-token stack (C = 25, H = 896): ``Proj(use_t5=True)`` with 2
    T5 layers of 12 x 64 heads (its attention takes the relative position
    bias, so the plain route: it launches nothing) makes one 1024^2 image
    with the text image's exact counts; ``TransformerProj`` (TPROJ) in
    f32, its attention K1's f32 instance 3 times a call, its outputs
    within TPROJ_REL_L2 relative L2 of its plain route's; ``LegacyProj``
    "proj3" in f32, timed. -> the launch counts of the image and of one
    ``TransformerProj`` call."""
    import dataclasses

    import torch
    from x2i_torch.models.proj import Proj
    from x2i_torch.models.proj_variants import (LegacyProj,
                                                LegacyProjConfig,
                                                TransformerProj)
    from x2i_torch.params import random_init_

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    cfg = dataclasses.replace(pipe.proj.cfg, use_t5=True, num_layers=2,
                              num_heads=12, head_dim=64)
    refined = random_init_(Proj(cfg, dev), g)
    with torch.inference_mode():
        stack = pipe.encoder_fn({"task": "text2image", "prompt": PROMPTS[0]})
        reset_counts()
        refined(stack)
        alone = launch_counts()
        refiner_ms = call_ms(lambda: refined(stack), iters=5)
    want = expected_launches(False, 4)
    rec, pixels, counts = run_image(dataclasses.replace(pipe, proj=refined),
                                    seed, "proj-t5", want)
    rec.update(card=card, refiner_ms=refiner_ms, stack=list(stack.shape),
               refiner_launches=sum(alone.values()))
    emit(rec)
    if counts != want or any(alone.values()):
        raise AssertionError(f"the refined proj's image is wrong: {rec}")
    del refined

    x = stack[:, -1].float()                        # (1, 512, 896)
    kern = random_init_(TransformerProj(**TPROJ, device=dev), g)
    plain = TransformerProj(**TPROJ, device=dev, attention_impl="plain")
    plain.load_state_dict(kern.state_dict())
    with torch.inference_mode():
        reset_counts()
        got = kern(x)
        tp_counts = launch_counts()
        want_out = plain(x)
        plain_counts = launch_counts()
        kern_ms = call_ms(lambda: kern(x))
        plain_ms = call_ms(lambda: plain(x))
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(got, want_out)]
    want_tp = dict(NO_LAUNCHES, flash_fwd_f32=TPROJ["num_layers"])
    rec = {"phase": "proj-transformer-f32", "card": card, **TPROJ,
           "tokens": x.shape[1], "ms": kern_ms, "plain_ms": plain_ms,
           "rel_l2_pooled_seq": rel, "launches": tp_counts,
           "launches_expected": want_tp,
           "finite": all(bool(torch.isfinite(t).all()) for t in got)}
    emit(rec)
    if not (tp_counts == want_tp and plain_counts == tp_counts
            and max(rel) <= TPROJ_REL_L2 and rec["finite"]):
        raise AssertionError(f"TransformerProj's route is wrong: {rec}")
    del kern, plain

    lcfg = LegacyProjConfig(in_channels=cfg.in_channels,
                            input_dim=cfg.input_dim, output_dim0=768,
                            output_dim1=4096, num_heads=12, head_dim=64)
    legacy = random_init_(LegacyProj(lcfg, "proj3", device=dev), g)
    xs = stack.float()
    with torch.inference_mode():
        reset_counts()
        pooled, seq = legacy(xs)
        used = launch_counts()
        ms = call_ms(lambda: legacy(xs), iters=3)
    rec = {"phase": "proj-legacy-proj3-f32", "card": card,
           "t5_layers": lcfg.num_layers, "stack": list(xs.shape), "ms": ms,
           "shapes": [list(pooled.shape), list(seq.shape)],
           "finite": bool(torch.isfinite(seq).all()),
           "launches": sum(used.values())}
    emit(rec)
    if not (rec["finite"] and rec["shapes"] == [[1, 768], [1, 512, 4096]]
            and not any(used.values())):
        raise AssertionError(f"LegacyProj proj3 is wrong: {rec}")
    del legacy, xs, stack
    _free()
    return {"proj-t5": counts, "transformer-proj": tp_counts}


def phase_text2image_2048(pipe, seed: int):
    """One 2048 x 2048, 4-step image on the bf16 pipeline: 16,384 image +
    512 text tokens, so every DiT attention is K2 with the qk norm and the
    rope applied outside it, the LM's 512-token prefill stays K1b, and the
    VAE decodes 6 x 6 tiles of 64 latents. Then the 2+2-block route check
    above 8192 tokens. -> (the launch counts, the image's pixels before
    postprocess)."""
    px = 2048
    want = expected_launches(False, 4, joint_tokens=512 + (px // 16) ** 2)
    rec, pixels, counts = run_image(pipe, seed, "text2image-2048", want, px)
    emit(rec)
    if counts != want or not rec["vae_decode_tiled"]:
        raise AssertionError(f"the 2048^2 path missed its kernels: {counts} "
                             f"!= {want}")
    check_routes(seed + 3, 1536, "text2image-2048-reference")
    return counts, pixels


def d256_dit(flux):
    """The 12 x 256 DiT (``D256``: FLUX's width and depth, its heads
    regrouped) on the serving DiT's weights: every parameter of the same
    shape is the serving DiT's own tensor (the linear layers: the same
    3072-wide shapes), only the qk-norm scales are new (256 wide, ones, as
    ``random_init_`` draws norm scales). No second 23.8 GB DiT: it is
    built on the meta device and given the serving DiT's parameters."""
    import dataclasses

    import torch
    from x2i_torch.models.flux import FluxTransformer2D

    cfg = dataclasses.replace(flux.cfg, **D256)
    model = FluxTransformer2D(cfg, torch.device("meta"))
    served = dict(flux.named_parameters())
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        own = served[name]
        if own.shape != p.shape:
            own = torch.nn.Parameter(torch.ones(p.shape, dtype=p.dtype,
                                                device=own.device),
                                     requires_grad=False)
        setattr(model.get_submodule(mod_name), leaf, own)
    return model


def phase_d256(pipe, seed: int, card: str):
    """The 12 x 256 FLUX DiT (``d256_dit``, bf16, the serving config's
    fused glue) through the public ``X2IPipeline.text2image`` path
    (``run_image``: a warm-up image, then the image with the counts set to
    0 just before and read just after): a 1024^2 image (K1a at D = 256,
    228 launches at (1, 12, 4608, 256)), a 2048^2 image (K2 at D = 256, 228
    at (1, 12, 16896, 256)) and a 960^2 image (4112 joint tokens: the pad
    route, K1's masked body with the rope at D = 256, 228), each held to
    its exact counts (K5 460, the LM's K1b 24) and followed by a 2 + 2
    block route check at D = 256 against the plain route (``check_routes``:
    512^2, 1536^2 above 8192 tokens, 480^2 on the pad route). -> ({run
    label: launches}, {px: the 1024^2 and 2048^2 images, uint8})."""
    import dataclasses

    from x2i_torch.models.vae import postprocess

    t0 = time.perf_counter()
    flux = d256_dit(pipe.flux)
    p256 = dataclasses.replace(pipe, flux=flux)
    runs, images = {}, {}
    for label, px, ref_px in (("d256", 1024, 512), ("d256-2048", 2048, 1536),
                              ("d256-960", 960, 480)):
        joint = 512 + (px // 16) ** 2
        want = expected_launches(False, 4, joint_tokens=joint, head_dim=256)
        rec, pixels, counts = run_image(p256, seed, label, want, px)
        if px in (1024, 2048):
            # the image run_task gave: the same seed's noise, postprocessed
            images[px] = postprocess(pixels).cpu().numpy()
        rec.update(head_dim=256, heads=D256["num_attention_heads"],
                   route=("chunked" if joint > 8192 else
                          "pad" if joint % 128 else "kernel"), card=card)
        emit(rec)
        if counts != want:
            raise AssertionError(f"the {label} image missed its kernels: "
                                 f"{counts} != {want}")
        runs[label] = counts
        check_routes(seed + 5, ref_px, f"{label}-reference", head_dim=256)
    emit({"phase": "d256-summary", "seconds": time.perf_counter() - t0,
          "card": card})
    return runs, images


# the phase-2 step on the 12 x 256 DiT with a text2image conditioning (K1b
# in the LM's 24 layers): the 24 x 128 DiT's counts (K1's pipelined body
# once in the first double block, whose attention does not depend on the
# controls; in the 56 blocks after it K1 with the lse in the forward and
# again in the remat recompute, K3 and K4 once) under the ``_d256`` names,
# and in f32 under the f32 instances'
LIGHTCONTROL_D256_LAUNCHES = dict(
    NO_LAUNCHES, flash_fwd=24, flash_fwd_pipe_d256=1, flash_fwd_lse_d256=112,
    flash_bwd_dq_d256=56, flash_bwd_dkv_d256=56)
LIGHTCONTROL_F32_D256_LAUNCHES = dict(
    NO_LAUNCHES, flash_fwd=24, flash_fwd_f32_d256=1,
    flash_fwd_lse_f32_d256=112, flash_bwd_dq_f32_d256=56,
    flash_bwd_dkv_f32_d256=56)


def phase_d256_train(pipe, seed: int, card: str, label: str = "d256-train",
                     want=LIGHTCONTROL_D256_LAUNCHES, steps: int = 3):
    """The phase-2 step (``phase_lightcontrol_steps``: 32-bit AdamW, 1024^2,
    a text2image conditioning) on the 12 x 256 DiT (``d256_dit`` on the
    pipeline's DiT as it stands, bf16 or f32): one warm-up and ``steps - 1``
    timed steps with exact launch counts (``want``), every call of the
    plain attention recorded (``plain_attention_calls``): none at D = 256.
    -> {label: the last step's launches}."""
    import dataclasses

    t0 = time.perf_counter()
    p256 = dataclasses.replace(pipe, flux=d256_dit(pipe.flux))
    shapes = []
    with plain_attention_calls(shapes):
        launches = phase_lightcontrol_steps(p256, seed, card, label, want,
                                            steps=steps, use_8bit_adam=False)
    at_256 = [sh for sh in shapes if sh[-1] == 256]
    emit({"phase": f"{label}-plain-attention",
          "seconds": time.perf_counter() - t0,
          "plain_attention_shapes": sorted(set(shapes)),
          "plain_attention_calls_at_d256": len(at_256), "card": card})
    if at_256:
        raise AssertionError(f"{label}: {len(at_256)} plain attentions at "
                             f"D = 256: {sorted(set(at_256))}")
    return {label: launches}


def phase_d256_ring(pipe, images: dict, seed: int, card: str):
    """``d256-ring``: the 12 x 256 DiT (``d256_dit``) under
    ``ring_sequence`` on a ring of 4 in the one-process form (the glue
    unfused, the qk norm and rope outside the kernels): a 1024^2 image as
    the warm-up, then 4-step images at 1024^2 and 2048^2 through
    ``run_task`` with every launch count set to 0 just before and read just
    after (each attention 16 pairs of K1 with the lse at (1, 12, 1152, 256)
    and (1, 12, 4224, 256): 57 x 16 x 4 an image, the LM's K1b 24), each
    held to ring-image's bar against the unsharded 12 x 256 image of
    ``phase_d256`` (``images``: the same seed and noise on the kernel
    route, the glue fused). -> {run label: launches}."""
    import dataclasses

    import numpy as np
    from x2i_torch.parallel.axis import LocalAxis

    t0 = time.perf_counter()
    p256 = dataclasses.replace(pipe, flux=d256_dit(pipe.flux))
    flux, steps = p256.flux, 4
    req = {"task": "text2image", "prompt": PROMPTS[0]}
    blocks = flux.cfg.num_layers + flux.cfg.num_single_layers
    want = dict(NO_LAUNCHES, flash_fwd=24,
                flash_fwd_lse_d256=blocks * RING * RING * steps)
    runs = {}
    flux.replace_config(ring_sequence=True)
    flux.set_ring_axis(LocalAxis(RING, "tensor"))
    try:
        w0 = time.perf_counter()
        p256.run_task(**req, seed=seed, height=1024, width=1024,
                      num_steps=steps)
        warm_s = time.perf_counter() - w0
        for px in (1024, 2048):
            reset_counts()
            w0 = time.perf_counter()
            img = p256.run_task(**req, seed=seed, height=px, width=px,
                                num_steps=steps)
            sec = time.perf_counter() - w0
            counts = launch_counts()
            a, b = img.astype(np.float32), images[px].astype(np.float32)
            levels = np.abs(a - b)
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            rec = {"phase": "d256-ring", "px": px, "steps": steps,
                   "ring": RING, "head_dim": 256,
                   "heads": D256["num_attention_heads"],
                   "shard_tokens": (512 + (px // 16) ** 2) // RING,
                   "s_per_image": sec,
                   "warmup_s": warm_s if px == 1024 else None,
                   "first_call": px != 1024,
                   "image_shape": list(img.shape),
                   "max_level_diff": float(levels.max()),
                   "mean_level_diff": float(levels.mean()), "rel_l2": rel,
                   "against": "the unsharded 12 x 256 image (d256 / "
                              "d256-2048)",
                   "launches": counts, "card": card}
            emit(rec)
            if (counts != want or img.shape != (1, px, px, 3)
                    or rel > RING_IMAGE_REL_L2 or float(a.std()) == 0.0):
                raise AssertionError(f"d256-ring at {px}^2 is wrong: {rec} "
                                     f"(launches expected {want})")
            runs[f"d256-ring-{px}"] = counts
    finally:
        flux.set_ring_axis(None)
        flux.replace_config(ring_sequence=False)
    emit({"phase": "d256-ring-summary", "seconds": time.perf_counter() - t0,
          "card": card})
    return runs


# the phase-2 step on the f32 DiT with a text2image conditioning (K1b in
# the LM's 24 layers): per step K1's f32 forward in the first double block
# (its attention does not depend on the controls), then in the 56 blocks
# after it K1's f32 instance with the lse in the forward and again in the
# remat recompute, K3's and K4's once
LIGHTCONTROL_F32_LAUNCHES = dict(NO_LAUNCHES, flash_fwd=24, flash_fwd_f32=1,
                                 flash_fwd_lse_f32=112, flash_bwd_dq_f32=56,
                                 flash_bwd_dkv_f32=56)
F32_PX = 2048


def set_dit_dtype(flux, dtype):
    """The DiT's parameters cast to ``dtype`` in place, one tensor at a
    time (never a second whole DiT: 23.8 GB in bf16, 47.6 in f32), and its
    config's dtype set. bf16 -> f32 -> bf16 is exact. A quantized DiT's
    layers take ``dtype`` as theirs (their codes and f32 scales stay as
    they are, the quantizers' f32 result on the bf16-exact weights: the
    tree JAX builds for an f32 DiT)."""
    import torch
    from x2i_torch.ops.quant import QuantLinear
    for m in flux.modules():
        if isinstance(m, QuantLinear):
            m.dtype = dtype
    moved = 0
    for p in flux.parameters():
        p.data = p.data.to(dtype)
        moved += p.numel()
        if moved > 1 << 29:
            # the cached blocks of the narrower tensors cannot hold the
            # wider ones: hand them back as the cast goes
            torch.cuda.empty_cache()
            moved = 0
    flux.replace_config(dtype=dtype)


@contextlib.contextmanager
def plain_attention_calls(shapes: list):
    """Within it every call of the plain attention records its q shape
    (B, H, S, D) in ``shapes``."""
    from x2i_torch.ops import flash_attention as fa
    plain = fa.xla_attention

    def counted(q, *args, **kw):
        shapes.append(tuple(q.shape))
        return plain(q, *args, **kw)

    fa.xla_attention = counted
    try:
        yield shapes
    finally:
        fa.xla_attention = plain


def f32_image(pipe, bf16_pixels, seed: int, card: str):
    """One 2048^2, 4-step text2image on the f32 DiT, its glue unfused (the
    f32 DiT's serving config, JAX's default): one f32 DiT step at 2048^2
    first as its warm-up (timed), then the image with every launch count
    set to 0 just before and read just after (exact: K2's f32 instance 228
    times, the LM's K1b 24, nothing else), the plain attention's calls
    recorded (none at the DiT's 24 x 128 heads: the VAE's one-head
    attention at D = 512 takes it by design), the card's peak memory
    against its size, and the image's relative L2 distance from the bf16
    image's (both postprocessed to uint8 levels). -> the launch counts."""
    import torch
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.models.vae import postprocess

    px, dev = F32_PX, pipe.device
    s_img = (px // 16) ** 2
    want = expected_launches(False, 4, joint_tokens=512 + s_img,
                             dtype="f32")
    with torch.inference_mode():
        pooled, emb = pipe.encode({"task": "text2image",
                                   "prompt": PROMPTS[0]})
        g = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn((1, s_img, 64), generator=g, device=dev,
                            dtype=torch.bfloat16)
        args = (noise, emb, pooled, torch.full((1,), 1.0, device=dev),
                prepare_latent_image_ids(px // 8, px // 8, dev),
                torch.zeros((emb.shape[1], 3), device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = pipe.flux(*args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        step_finite = bool(torch.isfinite(step).all())
        del step
    torch.cuda.reset_peak_memory_stats()
    shapes = []
    reset_counts()
    t0 = time.perf_counter()
    with plain_attention_calls(shapes):
        img = pipe.text2image(PROMPTS[0], seed=seed, height=px, width=px,
                              num_steps=4)
    sec = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    ref = postprocess(bf16_pixels).float()
    got = torch.from_numpy(img).to(ref.device).float()
    dit_plain = [sh for sh in shapes if sh[1] == 24 and sh[-1] == 128]
    rec = {"phase": "f32-2048", "model": MODEL, "px": px, "steps": 4,
           "dtype": "float32", "fused_glue": pipe.flux.cfg.fused_glue,
           "joint_tokens": 512 + s_img, "warmup_dit_step_s": step_s,
           "warmup_step_finite": step_finite, "s_per_image": sec,
           "image_shape": list(img.shape), "image_dtype": str(img.dtype),
           "pixels_std": float(img.std()),
           "max_memory_allocated": peak, "device_memory": total,
           "rel_l2_vs_bf16_image": ((got - ref).norm() / ref.norm()).item(),
           "plain_attention_calls": len(shapes),
           "plain_attention_shapes": sorted(set(shapes)),
           "dit_plain_attention_calls": len(dit_plain),
           "dit_weight_bytes": sum(t.numel() * t.element_size()
                                   for t in pipe.flux.parameters()),
           "launches": counts, "launches_expected": want, "card": card}
    emit(rec)
    if not (counts == want and not dit_plain and peak < total
            and step_finite and tuple(img.shape) == (1, px, px, 3)
            and str(img.dtype) == "uint8" and float(img.std()) > 0):
        raise AssertionError(f"the f32 2048^2 image is wrong: {rec}")
    return counts


F32_FUSED_PX = 1024


def f32_fused_image(pipe, seed: int, card: str):
    """The f32 DiT serving with ``fused_glue=True`` (JAX's "ln" glue: K5's
    f32 instance, and the qk norm with the rope inside K1's f32
    rope-and-norm instance): the same 1024^2, 4-step text2image first with
    the glue unfused (the rope alone inside the same instance), then fused,
    each with every launch count set to 0 just before and read just after
    (exact: unfused K1's rope-and-norm instance 228, the LM's K1b 24;
    fused also K5's f32 instance 460) and its s/image; the fused image's
    relative L2 distance from the unfused one's (uint8 levels) at most
    2e-2 (the two round the qk-normed q and k to bf16 at different points
    for the tensor cores, as the interleaved layout's image does against
    the half layout's). -> {run label: launches}."""
    import numpy as np
    import torch

    px, flux = F32_FUSED_PX, pipe.flux
    runs, images, secs = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    try:
        for label, fused in (("f32-unfused", False), ("f32-fused", True)):
            flux.replace_config(fused_glue=fused)
            want = expected_launches(False, 4, dtype="f32", f32_fused=fused)
            reset_counts()
            t0 = time.perf_counter()
            images[label] = pipe.text2image(PROMPTS[0], seed=seed, height=px,
                                            width=px, num_steps=4)
            secs[label] = time.perf_counter() - t0
            runs[label] = launch_counts()
            if runs[label] != want:
                raise AssertionError(f"the {label} image missed its kernels:"
                                     f" {runs[label]} != {want}")
    finally:
        flux.replace_config(fused_glue=False)
    ref = images["f32-unfused"].astype(np.float32)
    got = images["f32-fused"].astype(np.float32)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    rec = {"phase": "f32-fused", "model": MODEL, "px": px, "steps": 4,
           "dtype": "float32", "s_per_image": secs["f32-fused"],
           "s_per_image_unfused": secs["f32-unfused"],
           "rel_l2_vs_unfused_image": rel,
           "image_shape": list(images["f32-fused"].shape),
           "pixels_std": float(images["f32-fused"].std()),
           "launches": runs["f32-fused"],
           "launches_unfused": runs["f32-unfused"], "card": card,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(rec)
    if not (rel <= 2e-2 and rec["pixels_std"] > 0
            and tuple(images["f32-fused"].shape) == (1, px, px, 3)):
        raise AssertionError(f"the fused f32 image is wrong: {rec}")
    return runs


def phase_f32(pipe, bf16_2048, seed: int, card: str):
    """The f32 FLUX DiT on the card: the pipeline's bf16 DiT cast in place
    to f32 (``set_dit_dtype``), its glue unfused, then the 2048^2 f32 image
    (``f32_image``: K2's f32 instance), the 1024^2 f32 image unfused and
    with the glue fused (``f32_fused_image``: K5's f32 instance and K1's
    f32 rope-and-norm instance) and the phase-2 step on it
    (``lightcontrol-train-f32``: K1's f32 instance with the lse, K3's and
    K4's; 32-bit AdamW on the f32 bank, one warm-up and one timed step);
    then the DiT cast back to bf16 in its serving config and held bit for
    bit the one before (a checksum), and the 2 + 2-block route checks in
    f32: the image's above 8192 tokens (1536^2), the fused glue's at 512^2
    and the phase-2 gradient's. -> {run label: launches}."""
    import torch

    t0 = time.perf_counter()
    flux = pipe.flux
    checksum = param_checksum(flux)
    serving = {k: getattr(flux.cfg, k) for k in ("fused_glue", "remat",
                                                   "rope_in_kernel")}
    set_dit_dtype(flux, torch.float32)
    flux.replace_config(fused_glue=False)
    _free()
    cast_s = time.perf_counter() - t0
    try:
        runs = {"f32-2048": f32_image(pipe, bf16_2048, seed, card)}
        runs.update(f32_fused_image(pipe, seed, card))
        runs["lightcontrol-train-f32"] = phase_lightcontrol_steps(
            pipe, seed, card, "lightcontrol-train-f32",
            LIGHTCONTROL_F32_LAUNCHES, steps=2, use_8bit_adam=False)
        runs.update(phase_d256_train(
            pipe, seed, card, "lightcontrol-train-f32-d256",
            LIGHTCONTROL_F32_D256_LAUNCHES, steps=2))
    finally:
        set_dit_dtype(flux, torch.bfloat16)
        flux.replace_config(**serving)
        _free()
    restored = param_checksum(flux) == checksum
    emit({"phase": "f32-summary", "cast_s": cast_s,
          "seconds": time.perf_counter() - t0, "bf16_restored": restored,
          "card": card})
    if not restored:
        raise AssertionError("the bf16 DiT is not bit for bit the one "
                             "before the f32 phases")
    check_routes(seed + 3, 1536, "text2image-2048-f32-reference",
                 dtype="f32")
    check_routes(seed + 4, 512, "f32-fused-reference", dtype="f32",
                 f32_fused=True)
    check_lightcontrol_routes(seed, dtype="f32")
    # the 32 x 128 DiT in f32: K5's f32 instance at 4096, and in w8a8 K6,
    # K7 and K8's at 4096, 16384 and 4096
    runs["f32-4096-reference"] = check_routes(
        seed + 5, 512, "f32-4096-reference", dtype="f32", f32_fused=True,
        wide=True)
    runs["f32-w8a8-4096-reference"] = check_routes_quant(
        seed + 6, "w8a8", "f32", wide=True)
    return runs


def phase_long_prompt(pipe, lm, seed: int):
    """A 32,768-token prompt (seeded ids, 30,000 valid, right-padded)
    through ``encode_premixed`` and ``Proj.mlp`` on the full LM and proj:
    one warm-up, then one encode with the launch counts set to 0 just
    before and read just after (24 K2 launches, one per layer, and no K1),
    and a timed one. Then the streamed encode against the stack route
    (``Qwen2LM.__call__`` + ``Proj``) at 8,448 tokens (8,000 valid), which
    also takes K2: the stack route mixes the channels in bf16, the streamed
    one in f32, so they agree to bf16 accuracy, relative L2 at most 2e-2."""
    import numpy as np
    import torch
    from x2i_torch.models.proj import streaming_mix_spec

    dev = pipe.device
    weights, mix_fn = streaming_mix_spec(pipe.proj,
                                         lm.cfg.num_hidden_layers)
    rng = np.random.default_rng([seed, 32768])

    def prompt(s, valid):
        ids = np.zeros((1, s), np.int64)
        ids[0, :valid] = rng.integers(0, lm.cfg.vocab_size, valid)
        return (torch.as_tensor(ids, device=dev),
                torch.arange(s, device=dev)[None] < valid)

    def encode(ids, mask):
        with torch.inference_mode():
            mixed, _ = lm.encode_premixed(ids, weights, mix_fn,
                                          attention_mask=mask)
            out = pipe.proj.mlp(mixed)
        torch.cuda.synchronize()
        return out

    s, valid = 32768, 30000
    ids, mask = prompt(s, valid)
    t0 = time.perf_counter()
    encode(ids, mask)                                    # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pooled, embeds = encode(ids, mask)                   # the main path
    sec = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        encode(ids, mask)
        times.append(time.perf_counter() - t0)
    want = dict(NO_LAUNCHES, flash_chunked=lm.cfg.num_hidden_layers)
    finite = bool(torch.isfinite(pooled).all()
                  and torch.isfinite(embeds).all())
    rec = {"phase": "long-prompt", "model": MODEL, "tokens": s,
           "valid_tokens": valid, "encode_ms": sec * 1e3,
           "encode_ms_repeats": [t * 1e3 for t in times],
           "warmup_s": warm_s, "tokens_per_s": s / sec,
           "pooled_shape": list(pooled.shape),
           "embeds_shape": list(embeds.shape), "finite": finite,
           "embeds_std": embeds[:, :valid].float().std().item(),
           "max_memory_allocated": peak, "launches": counts,
           "launches_expected": want}
    emit(rec)
    if (counts != want or not finite or not rec["embeds_std"] > 0
            or tuple(pooled.shape) != (1, pipe.proj.cfg.output_dim0)
            or tuple(embeds.shape) != (1, s, pipe.proj.cfg.output_dim1)):
        raise AssertionError(f"the long-prompt encode is wrong: {rec}")
    del pooled, embeds, ids, mask

    s, valid = 8448, 8000
    ids, mask = prompt(s, valid)
    reset_counts()
    got = encode(ids, mask)
    used = launch_counts()
    with torch.inference_mode():
        states, _ = lm(ids, attention_mask=mask)
        ref = pipe.proj(states)
    rels = [((g.float() - r.float()).norm() / r.float().norm()).item()
            for g, r in zip(got, ref)]
    rec = {"phase": "long-prompt-reference", "tokens": s,
           "valid_tokens": valid, "stack_shape": list(states.shape),
           "pooled_rel_l2_err": rels[0], "embeds_rel_l2_err": rels[1],
           "kernel_launches": used}
    emit(rec)
    if not (max(rels) <= 2e-2 and used == want):
        raise AssertionError(f"the streamed encode disagrees with the stack "
                             f"route: {rec}")
    return counts


def distill_step_launches(n2: int, n1: int, lm_layers: int = 24) -> dict:
    """The flash kernels' launches in one phase-1 training step over a DiT
    of n2 double and n1 single blocks (each one joint attention), remat
    on, rope outside the kernel, and an LM of ``lm_layers``: the teacher's
    forward under no grad (K1c, the pipelined body: no mask, at least two
    kv chunks), the student's forward and its recompute under remat (K1
    with the lse), its backward (K3, K4), the LM's masked causal prefill
    (K1b); T5 (its bias) and CLIP (77 causal tokens) attend on the plain
    route; no glue kernel, no GEMM."""
    blocks = n2 + n1
    return dict(NO_LAUNCHES, flash_fwd_pipe=blocks, flash_fwd_lse=2 * blocks,
                flash_bwd_dq=blocks, flash_bwd_dkv=blocks,
                flash_fwd=lm_layers)


DISTILL_LAUNCHES = distill_step_launches(19, 38)


def quantized_step_launches(n2: int, n1: int, mode: str = "w8a8"):
    """The launches of a quantized DiT's kernels (K8, the GEMM and the
    dequantize kernel of ``mode``; w4: the dequantizing GEMM and the w4
    dequantize kernel) in one training step over n2 double and
    n1 single blocks, remat on, the glue unfused: -> (the student's
    forward and backward under the KD loss, the same after the teacher's
    forward, a phase-2 step under the velocity's MSE), each {name: count}.

    Every dense layer quantizes its rows (K8) and runs the GEMM once per
    forward: 14 in a double block, 6 in a single, 8 outside the blocks
    (x, context, time in/out, pooled in/out, norm_out, proj_out); under
    remat each block runs again in the backward. The backward dequantizes
    the weight of each layer whose input needs a gradient and whose
    output reaches the loss: under the KD loss every block's layers but
    the last single block's mlp_in and out (they reach only the
    velocity), and context, pooled in and out (the latents and the
    timestep need none; norm_out and proj_out reach only the velocity).
    In phase 2 the gradient starts at the first double block's control:
    that block runs once and dequantizes nothing; the second dequantizes
    its image q, k, v, both attention outs and both MLPs (9: its text
    q, k, v read no control yet), the others their 12 layers but the two
    adaLN rows (temb needs no gradient), each single block its 5 but the
    adaLN rows, and proj_out."""
    gemm, deq = {"w8a8": ("int8_gemm", "int8_dequant"),
                 "w4a8": ("w4a8_gemm", "w4a8_dequant"),
                 "w4": ("dequant_gemm", "w4_dequant")}[mode]
    blocks = 14 * n2 + 6 * n1

    def counts(fwd, bwd):
        # w4 quantizes no activations: its GEMM dequantizes the weight
        rows = {} if mode == "w4" else {"quant_rows": fwd}
        return {**rows, gemm: fwd, deq: bwd}

    return (counts(8 + 2 * blocks, blocks + 1),
            counts(blocks + 8 + 8 + 2 * blocks, blocks + 1),
            counts(8 + 14 + 2 * (blocks - 14),
                   9 + 12 * (n2 - 2) + 5 * n1 + 1))


def phase_distill(pipe, lm, seed: int, card: str, after=None):
    """Phase-1 distillation at full width and depth, batch 1, bf16, on the
    pipeline's DiT and LM weights (the DiT set to the trainer's config:
    remat on, rope outside the kernel, no fused glue; set back after).
    DistillConfig defaults except lr_warmup_steps=1: one warm-up step (its
    learning rate is 0) and three timed steps, each teacher then student,
    every launch count set to 0 just before each step and read just after.
    Checks: loss and grad_norm finite, grad_norm > 0, the proj changed by
    every timed step, the launch counts exact. ``after(teacher_fn,
    student_fn, state, batch)`` runs on the trainer before it is freed."""
    import torch
    from x2i_torch.train.harness import build_random_distill
    from x2i_torch.train.runner import step_noise

    t0 = time.perf_counter()
    (teacher_fn, student_fn), state, batch, parts = build_random_distill(
        "full", seed, flux=pipe.flux, lm=lm)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps = []
    for i in range(4):
        before = [p.detach().clone() for p in state.proj.parameters()]
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        noise = step_noise(seed, i)
        with StepClock() as clock:
            t0 = time.perf_counter()
            teacher_out = teacher_fn(batch, noise)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = student_fn(state, batch, teacher_out, noise)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            t2 = time.perf_counter()
        del teacher_out
        counts = launch_counts()
        change = max((p.detach().float() - b.float()).abs().max().item()
                     for p, b in zip(state.proj.parameters(), before))
        rec = {"phase": "distill", "step": i + 1, "warmup": i == 0,
               "teacher_s": t1 - t0, "student_s": t2 - t1,
               "step_s": t2 - t0, "loss": loss, "grad_norm": gnorm,
               "gc_s": clock.gc_s, "alloc_retries": clock.alloc_retries,
               "lr": parts["optimizer"].learning_rate(i),
               "proj_max_abs_change": change, "launches": counts}
        emit(rec)
        steps.append(rec)
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
                and (i == 0 or change > 0) and counts == DISTILL_LAUNCHES):
            raise AssertionError(f"distillation step {i + 1} is wrong: {rec}"
                                 f" (launches expected {DISTILL_LAUNCHES})")
    timed = steps[1:]
    summary = {"phase": "distill-summary", "model": MODEL,
               "latents": [128, 128], "tokens": [4096, 512], "batch": 1,
               "build_s": build_s,
               "s_per_step": statistics.mean(r["step_s"] for r in timed),
               "teacher_s": statistics.mean(r["teacher_s"] for r in timed),
               "student_s": statistics.mean(r["student_s"] for r in timed),
               "steps_s": [r["step_s"] for r in timed],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches_per_step": DISTILL_LAUNCHES,
               "remat": pipe.flux.cfg.remat, "card": card}
    emit(summary)
    if after is not None:
        state = after(teacher_fn, student_fn, state, batch)
    del state, parts, batch, teacher_fn, student_fn
    pipe.flux.replace_config(remat=False, rope_in_kernel=True,
                             fused_glue=True)
    torch.cuda.empty_cache()
    check_distill_routes(seed)
    return steps[-1]["launches"], summary


def check_distill_routes(seed: int, mode=False):
    """The conditioning gradient of the KD loss on a full-width DiT cut to
    2 double + 2 single blocks, at the training point (4096 image + 512
    text tokens, sigma 1), the trainer's config, through the kernel route
    (K1 with the lse, K3, K4) and through the plain attention on the same
    bf16 weights and teacher stacks. The two round at other points (the
    plain route keeps p and ds in f32), so they agree to bf16 accuracy:
    correlation above 0.99, relative L2 error below 5e-2. With ``mode``
    "w8a8" the DiT is quantized (drawn weights quantized), the kernel
    route adds K8, the int8 GEMM forward and the int8 dequantize kernel's
    straight-through backward, the plain route their plain versions
    (``quant_impl="plain"``), on the same int8 weights."""
    import dataclasses

    import torch
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.params import random_init_

    dev = torch.device("cuda")
    base = dataclasses.replace(MODEL_REGISTRY[MODEL].flux, num_layers=2,
                               num_single_layers=2, remat=True,
                               rope_in_kernel=False, quantized=mode)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    kern = random_init_(FluxTransformer2D(base, dev), g).requires_grad_(False)
    plain = FluxTransformer2D(dataclasses.replace(
        base, attention_impl="plain", quant_impl="plain"),
        dev).requires_grad_(False)
    plain.load_state_dict(kern.state_dict())

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    lat, t = rnd(1, 4096, 64), torch.ones((1,), device=dev)
    ids = (prepare_latent_image_ids(128, 128, dev),
           torch.zeros((512, 3), device=dev))
    with torch.no_grad():
        _, teacher = kern(lat, rnd(1, 512, 4096), rnd(1, 768), t, *ids,
                          return_attn_outputs=True, aux_layout="scan")
    seq, pooled = rnd(1, 512, 4096), rnd(1, 768)

    def grads(model):
        s_, p_ = seq.clone().requires_grad_(), pooled.clone().requires_grad_()
        _, kl = model(lat, s_, p_, t, *ids, kd_targets=teacher,
                      aux_layout="scan")
        kl.backward()
        return torch.cat([s_.grad.flatten(), p_.grad.flatten()]).float()

    reset_counts()
    got = grads(kern)
    used = launch_counts()
    reset_counts()
    want = grads(plain)
    used_plain = launch_counts()
    rel = ((got - want).norm() / want.norm()).item()
    corr = torch.corrcoef(torch.stack([got, want]))[0, 1].item()
    want_used = dict(NO_LAUNCHES, flash_fwd_lse=8, flash_bwd_dq=4,
                     flash_bwd_dkv=4)
    if mode:
        want_used.update(quantized_step_launches(2, 2)[0])
    rec = {"phase": f"distill-{mode}-reference" if mode
           else "distill-reference", "blocks": [2, 2],
           "tokens": [4096, 512], "grad_rel_l2_err": rel, "grad_corr": corr,
           "grad_norm": want.norm().item(),
           "finite": bool(torch.isfinite(got).all()),
           "kernel_launches": used, "kernel_launches_expected": want_used,
           "plain_route_launches": used_plain}
    emit(rec)
    if not (rec["finite"] and corr > 0.99 and rel < 5e-2
            and used == want_used and not any(used_plain.values())):
        raise AssertionError(f"the training kernel route disagrees with the "
                             f"plain route: {rec}")


# ----------------------------------------------------------- LightControl

# ------------------------------------------------------------ data, eval

SHARDS, SHARD_SAMPLES = 2, 32
DATA_STEPS = 6                   # timed steps after one warm-up
REMOTE_STEPS = 2
LOADER_TIMEOUT_S = 60.0


def write_caption_shards(root: str, seed: int) -> str:
    """The phase-1 corpus's layout: SHARDS webdataset tar shards of
    SHARD_SAMPLES samples, each a json with caption_en / caption_zh and a
    txt, captions drawn from the seed; no image member (the card's machine
    has no PIL, and phase 1 trains on captions). -> the brace URL."""
    import io
    import os
    import random
    import tarfile

    rng = random.Random(seed)
    words = ("red fox snow lighthouse dusk harbour boats gulls old map "
             "compass rose glass tower rain street lamp night market").split()
    for j in range(SHARDS):
        with tarfile.open(os.path.join(root, f"cap-{j:02d}.tar"), "w") as tf:
            for i in range(SHARD_SAMPLES):
                cap = " ".join(rng.choice(words)
                               for _ in range(rng.randint(4, 24)))
                key = f"{j:02d}{i:04d}"
                for ext, data in (
                        ("json", json.dumps({"caption_en": cap,
                                             "caption_zh": "图: " + cap},
                                            ensure_ascii=False).encode()),
                        ("txt", cap.encode())):
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return os.path.join(root, "cap-{00..%02d}.tar" % (SHARDS - 1))


def teacher_tokenizers(family: str = "internvl"):
    """(MLLM, T5, CLIP) tokenizers of the phase-1 batches on the card."""
    return (ByteTokenizer(family), EndTokenizer(end=1, pad=0),
            EndTokenizer(end=49407, pad=49407))


def distill_datamodule(urls: str, seed: int):
    """The phase-1 datamodule over the caption shards at the trainer's
    shapes (MLLM and T5 ids 512, CLIP's 77), InternVL's template."""
    from x2i_torch.data.datamodule import (DistillDataConfig,
                                           DistillDataModule,
                                           family_chat_template, hf_tokenize)
    mllm, t5, clip_tok = teacher_tokenizers()
    return DistillDataModule(
        DistillDataConfig(urls=urls, batch_size=1, seed=seed),
        mllm_tokenize=hf_tokenize(mllm, 512),
        t5_tokenize=hf_tokenize(t5, 512),
        clip_tokenize=hf_tokenize(clip_tok, 77, with_mask=False),
        chat_template=family_chat_template(MODEL, mllm))


class KeptCopy:
    """A StreamCopy that keeps each numpy batch it copies, in order, so
    that the batch on the card can be held to it."""

    def __init__(self, copy):
        self.copy, self.host = copy, []

    def __call__(self, batch):
        self.host.append(batch)
        return self.copy(batch)

    def take(self, item):
        return self.copy.take(item)


def _same_on_card(batch, host) -> bool:
    import torch
    return batch.keys() == host.keys() and all(
        torch.equal(batch[k].cpu(), torch.from_numpy(host[k]))
        for k in host)


def _fetch_worker_main(port: int, urls: str, seed: int):
    """The remote fetch worker (a spawned process, no CUDA): index
    (shard path, sample position) -> that sample decoded and
    preprocessed into numpy."""
    from x2i_torch.data.remote import run_worker
    from x2i_torch.data.webdataset import decode_sample, tar_samples
    dm = distill_datamodule(urls, seed)
    shards = {}

    def fetch(index):
        path, i = index
        if path not in shards:
            shards[path] = list(tar_samples(iter([path])))
        return dm.preproc(decode_sample(shards[path][i]))

    run_worker("127.0.0.1", port, fetch, num_threads=2)


class StepClock:
    """What may stall a step besides its own work, measured while active:
    the seconds the interpreter spends in garbage collection (``gc_s``:
    a loader thread's objects can trigger a full collection inside the
    step) and the caching allocator's retries of a failed cudaMalloc
    after freeing its cache (``alloc_retries``: each synchronizes)."""

    def __enter__(self):
        import gc

        import torch
        self.gc_s, self._t = 0.0, None
        self._retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        gc.callbacks.append(self._gc)
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self._t = None

    def __exit__(self, *exc):
        import gc

        import torch
        gc.callbacks.remove(self._gc)
        self.alloc_retries = torch.cuda.memory_stats().get(
            "num_alloc_retries", 0) - self._retries


def _timed_step(teacher_fn, student_fn, state, batch, noise):
    import torch
    reset_counts()
    with StepClock() as clock:
        t0 = time.perf_counter()
        teacher_out = teacher_fn(batch, noise)
        state, metrics = student_fn(state, batch, teacher_out, noise)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    return state, {"step_s": step_s, "loss": loss, "grad_norm": gnorm,
                   "gc_s": clock.gc_s, "alloc_retries": clock.alloc_retries,
                   "launches": launch_counts()}


def phase_data_train(pipe, lm, seed: int, card: str):
    """Phase-1 distillation at full width and depth fed from tar shards:
    write 2 caption shards of 32 samples; build the trainer on the
    pipeline's DiT and LM (``build_random_distill``, its own batch
    unused), feed it from ``DistillDataModule.train_loader`` through
    ``PrefetchLoader`` (timeout 60 s) with the side-stream copy to the card
    (``StreamCopy``), tokenized by the script's byte-level tokenizers;
    one warm-up and six timed steps, then two steps from a
    ``RemoteFetchLoader`` whose ``FetchWorker`` runs in a spawned child
    process on 127.0.0.1 and does the preprocessing, and an epoch of 16
    samples through it for its rate. Per step: step_s, the consumer's wait
    on the loader (loader_wait_s), the loader thread's host ms for the
    batch, the launch counts. Checks: the counts DISTILL_LAUNCHES, loss and
    grad_norm finite, grad_norm > 0, the proj changed by every step after
    the warm-up, each batch on the card bit for bit its numpy batch, the
    native tar reader loaded (no wait passes the timeout: a pipeline whose
    every sample fails resamples forever, and the phase fails then). The
    steps run inside ``frozen_heap``, after the trainer's build, as in
    ``TrainLoop.run``: without it a full garbage collection walked the
    trainer inside one step in three."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import torch
    from x2i_torch.data import native_tar
    from x2i_torch.data.loader import StreamCopy, stack_collate
    from x2i_torch.data.remote import FetchService, RemoteFetchLoader
    from x2i_torch.train.harness import build_random_distill
    from x2i_torch.train.runner import frozen_heap, step_noise

    root = tempfile.mkdtemp(prefix="x2i_shards_")
    worker = None
    heap = contextlib.ExitStack()
    try:
        t0 = time.perf_counter()
        urls = write_caption_shards(root, seed)
        write_s = time.perf_counter() - t0
        (teacher_fn, student_fn), state, _, _ = build_random_distill(
            "full", seed, flux=pipe.flux, lm=lm)
        heap.enter_context(frozen_heap())
        dm = distill_datamodule(urls, seed)
        copy = KeptCopy(StreamCopy("cuda"))
        loader = dm.train_loader(copy, timeout=LOADER_TIMEOUT_S)
        it = iter(loader)
        steps = []
        for i in range(1 + DATA_STEPS):
            before = [p.detach().clone() for p in state.proj.parameters()]
            t0 = time.perf_counter()
            batch = next(it)
            wait = time.perf_counter() - t0
            state, rec = _timed_step(teacher_fn, student_fn, state, batch,
                                     step_noise(seed, i))
            change = max((p.detach().float() - b.float()).abs().max().item()
                         for p, b in zip(state.proj.parameters(), before))
            rec = {"phase": "data-train", "step": i + 1, "warmup": i == 0,
                   "loader": "prefetch", **rec, "loader_wait_s": wait,
                   "loader_host_ms": 1e3 * loader.host_s[i],
                   "batch_on_card_equal": _same_on_card(batch,
                                                        copy.host[i]),
                   "proj_max_abs_change": change}
            emit(rec)
            steps.append(rec)
            if not (rec["launches"] == DISTILL_LAUNCHES
                    and math.isfinite(rec["loss"])
                    and math.isfinite(rec["grad_norm"])
                    and rec["grad_norm"] > 0 and (i == 0 or change > 0)
                    and rec["batch_on_card_equal"]):
                raise AssertionError(f"data-fed step {i + 1} is wrong: "
                                     f"{rec} (launches expected "
                                     f"{DISTILL_LAUNCHES})")
        del it, loader

        with FetchService() as svc:
            worker = mp.get_context("spawn").Process(
                target=_fetch_worker_main, args=(svc.address[1], urls, seed),
                daemon=True)
            worker.start()
            paths = [f"{root}/cap-{j:02d}.tar" for j in range(SHARDS)]
            index = [(paths[i % SHARDS], i) for i in range(REMOTE_STEPS)]
            remote = iter(RemoteFetchLoader(index, svc,
                                            timeout=LOADER_TIMEOUT_S))
            for i in range(REMOTE_STEPS):
                t0 = time.perf_counter()
                sample = next(remote)
                wait = time.perf_counter() - t0
                host = stack_collate([sample])
                batch = copy.take(copy.copy(host))
                state, rec = _timed_step(teacher_fn, student_fn, state,
                                         batch, step_noise(seed, 10 + i))
                rec = {"phase": "data-train", "step": i + 1,
                       "loader": "remote", **rec, "loader_wait_s": wait,
                       "batch_on_card_equal": _same_on_card(batch, host)}
                emit(rec)
                steps.append(rec)
                if not (rec["launches"] == DISTILL_LAUNCHES
                        and math.isfinite(rec["loss"])
                        and rec["grad_norm"] > 0
                        and rec["batch_on_card_equal"]):
                    raise AssertionError(f"remote-fed step {i + 1} is "
                                         f"wrong: {rec}")
            if next(remote, None) is not None:
                raise AssertionError("the remote loader outran its sampler")
            epoch = [(paths[i % SHARDS], i % SHARD_SAMPLES)
                     for i in range(16)]
            t0 = time.perf_counter()
            got = list(RemoteFetchLoader(epoch, svc,
                                         timeout=LOADER_TIMEOUT_S))
            remote_s = time.perf_counter() - t0
            svc.stop()
            worker.join(timeout=30)
        timed = [r for r in steps if r["loader"] == "prefetch"][1:]
        summary = {
            "phase": "data-train-summary", "model": MODEL,
            "shards": SHARDS, "samples_per_shard": SHARD_SAMPLES,
            "write_s": write_s,
            "native_tar_loaded": native_tar.TAR_INDEX.loaded(),
            "s_per_step": statistics.mean(r["step_s"] for r in timed),
            "steps_s": [r["step_s"] for r in timed],
            "gc_s": [r["gc_s"] for r in timed],
            "loader_wait_s": [r["loader_wait_s"] for r in timed],
            "loader_host_ms": [r["loader_host_ms"] for r in timed],
            "remote_samples": len(got), "remote_epoch_s": remote_s,
            "remote_samples_per_s": len(got) / remote_s,
            "worker_exitcode": worker.exitcode,
            "loader_timeout_s": LOADER_TIMEOUT_S, "card": card}
        emit(summary)
        if not (summary["native_tar_loaded"] and len(got) == 16
                and worker.exitcode == 0):
            raise AssertionError(f"the data layer is wrong: {summary}")
        return steps[DATA_STEPS]["launches"], summary
    finally:
        heap.close()
        if worker is not None and worker.is_alive():
            worker.terminate()
            worker.join(timeout=10)
        shutil.rmtree(root)
        pipe.flux.replace_config(remat=False, rope_in_kernel=True,
                                 fused_glue=True)
        torch.cuda.empty_cache()


T5_CKPT_BLOCKS = 2                 # T5-XXL's encoder cut to 2 of 24 blocks


def write_teacher_dirs(root: str, seed: int):
    """A T5-XXL encoder directory at full width cut to T5_CKPT_BLOCKS
    blocks (HF T5EncoderModel names, config.json) and a whole CLIP-L text
    directory (CLIPTextModel names), weights drawn on the card in bf16.
    -> (t5 path, clip path, bytes written)."""
    import dataclasses
    import os

    import torch
    from x2i_torch.convert.torch_models import clip_text_plan, t5_plan
    from x2i_torch.core.config import CLIPTextConfig, T5Config
    from x2i_torch.models.clip import CLIPTextEncoder
    from x2i_torch.models.t5 import T5Encoder

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    t5_cfg = dataclasses.replace(T5Config(), num_layers=T5_CKPT_BLOCKS)
    clip_cfg = CLIPTextConfig()
    t5, clip_dir = os.path.join(root, "t5"), os.path.join(root, "clip")
    os.makedirs(t5)
    os.makedirs(clip_dir)
    written = write_safetensors(os.path.join(t5, "model.safetensors"),
                                _entries(T5Encoder, t5_cfg,
                                         t5_plan(t5_cfg), g))
    c = t5_cfg
    _write_json(os.path.join(t5, "config.json"), {
        "architectures": ["T5EncoderModel"], "model_type": "t5",
        "vocab_size": c.vocab_size, "d_model": c.d_model, "d_kv": c.d_kv,
        "d_ff": c.d_ff, "num_layers": c.num_layers, "num_heads": c.num_heads,
        "relative_attention_num_buckets": c.relative_attention_num_buckets,
        "relative_attention_max_distance":
            c.relative_attention_max_distance,
        "layer_norm_epsilon": c.layer_norm_eps,
        "feed_forward_proj": "gated-gelu"})
    written += write_safetensors(
        os.path.join(clip_dir, "model.safetensors"),
        _entries(CLIPTextEncoder, clip_cfg, clip_text_plan(clip_cfg), g))
    c = clip_cfg
    _write_json(os.path.join(clip_dir, "config.json"), {
        "architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
        "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
        "intermediate_size": c.intermediate_size,
        "num_hidden_layers": c.num_hidden_layers,
        "num_attention_heads": c.num_attention_heads,
        "max_position_embeddings": c.max_position_embeddings,
        "eos_token_id": c.eos_token_id, "hidden_act": "quick_gelu"})
    return t5, clip_dir, written


def _mismatches(module, files, plan) -> list:
    """The plan's destinations in ``module`` that are not bit for bit the
    checkpoint tensors of ``files`` ((key, tensor) pairs) they come from,
    compared on the module's device."""
    import torch
    targets = {**dict(module.named_parameters()),
               **dict(module.named_buffers())}
    bad = []
    for key, t in files:
        dests = plan[key] if isinstance(plan[key], list) else [plan[key]]
        for name, fn in dests:
            dst = targets[name]
            src = t.to(dst.device)
            if fn is not None:
                src = fn(src)
            if not torch.equal(src.to(dst.dtype), dst):
                bad.append(name)
    return bad


def phase_assemble(root: str, flux: str, mllm: str, proj: str, seed: int,
                   card: str):
    """``assemble_distill`` on the card from the checkpoint phase's
    directories (the DiT cut to CKPT_BLOCKS, InternViT + Qwen2.5-0.5B, the
    proj's .bin) with a T5-XXL encoder directory cut to 2 blocks and a
    whole CLIP-L text directory (``write_teacher_dirs``), the script's
    tokenizers, the caption shards; then 2 ``TrainLoop`` steps from the
    assembled loader. Checks: every tensor read bit for bit the one
    written (each module's plan against its files), nothing unread, the
    tensors read those written; loss finite; per step the launch counts
    ``distill_step_launches`` derives for the cut DiT. Records the load's
    time and bytes."""
    import gc
    import os

    import torch
    from x2i_torch.convert.load import load_safetensors_dir, load_torch_bin
    from x2i_torch.convert.torch_models import (clip_text_plan, flux_plan,
                                                internvl_plan, proj_plan,
                                                t5_plan)
    from x2i_torch.core.config import DistillConfig
    from x2i_torch.train.assemble import assemble_distill
    from x2i_torch.train.runner import TrainLoop

    t0 = time.perf_counter()
    t5, clip_dir, written = write_teacher_dirs(root, seed)
    os.makedirs(os.path.join(root, "shards"))
    urls = write_caption_shards(os.path.join(root, "shards"), seed)
    write_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_fn, state, parts, train_loader = assemble_distill(
        CKPT_MODEL, flux, mllm, t5, clip_dir, urls,
        dcfg=DistillConfig(lr_warmup_steps=1), proj_ckpt=proj,
        tokenizers=teacher_tokenizers())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rep = parts["load_report"]
    read = sum(r["bytes"] for r in rep.values())
    checks = {
        "flux": (parts["flux"], load_safetensors_dir(
            os.path.join(flux, "transformer")), flux_plan(parts["flux"].cfg)),
        "mllm": (parts["encoder"], load_safetensors_dir(mllm),
                 internvl_plan(parts["vl_cfg"])),
        "t5": (parts["t5"], load_safetensors_dir(t5),
               t5_plan(parts["t5"].cfg)),
        "clip": (parts["clip"], load_safetensors_dir(clip_dir),
                 clip_text_plan(parts["clip"].cfg)),
        "proj": (parts["proj"], ((k.removeprefix("module."), v) for k, v in
                                 load_torch_bin(proj).items()),
                 proj_plan(parts["proj"].cfg))}
    mismatched = {k: _mismatches(*v) for k, v in checks.items()}
    rec = {"phase": "assemble-load", "model": CKPT_MODEL,
           "dit_blocks": list(CKPT_BLOCKS), "t5_blocks": T5_CKPT_BLOCKS,
           "teacher_bytes_written": written, "write_s": write_s,
           "load_s": load_s, "bytes_read": read,
           "gb_per_s": read / load_s / 1e9,
           "tensors": {k: r["tensors"] for k, r in rep.items()},
           "unread": {k: r["unread"] for k, r in rep.items()},
           "mismatched": {k: v[:4] for k, v in mismatched.items() if v},
           "device_peak": torch.cuda.max_memory_allocated(), "card": card}
    emit(rec)
    if any(mismatched.values()) or any(r["unread"] for r in rep.values()):
        raise AssertionError(f"the assembled load is wrong: {rec}")

    want = distill_step_launches(*CKPT_BLOCKS)
    seen = []

    def on_metrics(step, metrics):
        seen.append({"step": step, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "launches": launch_counts()})
        reset_counts()

    loader = train_loader(timeout=LOADER_TIMEOUT_S)
    loop = TrainLoop(step_fn, state, loader, log_every=1, seed=seed,
                     on_metrics=on_metrics)
    reset_counts()
    out = loop.run(2)
    rec = {"phase": "assemble-train", "steps": seen,
           "timing": out["timing"], "launches_expected": want,
           "loader_wait_s": loader.wait_s[:2], "card": card}
    emit(rec)
    if not (len(seen) == 2 and all(math.isfinite(r["loss"])
                                   and r["launches"] == want
                                   for r in seen)):
        raise AssertionError(f"the assembled trainer is wrong: {rec}")
    del step_fn, state, parts, loop, loader
    gc.collect()
    torch.cuda.empty_cache()
    return seen[-1]["launches"]


EVAL_PX = 512
EVAL_SEEDS = 2


def clip_scorers(seed: int):
    """CLIP ViT-L/14 and CLIP-L's text tower with their projections, drawn
    on the card in f32 from the seed, and the same weights in bf16: ->
    (f32 scorer, bf16 scorer)."""
    import numpy as np
    import torch
    from x2i_torch.core.config import CLIPTextConfig, CLIPVisionConfig
    from x2i_torch.data.datamodule import hf_tokenize
    from x2i_torch.evalmetrics import scorer_from_model
    from x2i_torch.models.clip import CLIPModel
    from x2i_torch.params import random_init_

    tok = hf_tokenize(teacher_tokenizers()[2], 77, with_mask=False)

    def tokenize(text):
        return np.asarray(tok(text), np.int32)

    models = {}
    for dt in (torch.float32, torch.bfloat16):
        models[dt] = CLIPModel(CLIPTextConfig(dtype=dt),
                               CLIPVisionConfig(dtype=dt), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    random_init_(models[torch.float32], g)
    models[torch.bfloat16].load_state_dict(
        models[torch.float32].state_dict())
    return tuple(scorer_from_model(models[dt], tokenize)
                 for dt in (torch.float32, torch.bfloat16))


def clip_pixels(images):
    """The host half's stand-in on the card (no PIL there): uint8 (B, H, W,
    3) -> CLIP-normalized (B, 224, 224, 3) f32 through a bicubic
    antialiased resize."""
    import torch
    import torch.nn.functional as F
    from x2i_torch.evalmetrics import CLIP_MEAN, CLIP_STD
    x = torch.as_tensor(images, device="cuda").permute(0, 3, 1, 2).float()
    x = F.interpolate(x / 255.0, size=(224, 224), mode="bicubic",
                      antialias=True, align_corners=False)
    mean, std = (torch.as_tensor(a, device="cuda")[:, None, None]
                 for a in (CLIP_MEAN, CLIP_STD))
    return ((x - mean) / std).permute(0, 2, 3, 1).contiguous()


def phase_eval(pipe, seed: int, card: str):
    """The CLIP-T / CLIP-FID protocol on the card: CLIP ViT-L/14 (24 x
    1024, 16 heads, 224^2) and CLIP-L's text tower drawn from the seed;
    2 prompts x 2 seeds at 512^2 through ``seed_matched_protocol`` on the
    bf16 pipeline; the images resized on the card (``clip_pixels``);
    ``clip_t`` in bf16 and in f32. Checks: a bf16 ``image_features`` call
    launches K1b (the pad route) exactly 24 times and an f32 one K1's f32
    instance 24 times (the same route), and nothing else; each image's
    bf16 features within cosine 0.99 of its f32 ones and the bf16 scores
    within 0.3 CLIP-T points of the f32 ones (the bf16 - f32 gap measured
    0.097 with the f32 attention on the plain route; random weights keep
    every score within about 1.3 of 0, so a bar of 2 could not fail);
    the Fréchet distance of the two seeds' feature sets finite and >= 0,
    and 0 within 1e-6 for a set against itself. Records
    ``image_features`` ms a batch in both types: the caller's view
    (``call_ms``), and the host's enqueue against the card's time, the
    call replayed from a CUDA graph (``graph_step_times``: a call's some
    800 launches overflow the launch queue that ``kernel_ms`` fills)."""
    import numpy as np
    import torch
    from x2i_torch.evalmetrics import frechet_distance, seed_matched_protocol

    prompts = PROMPTS[:2]
    seeds = [seed + i for i in range(EVAL_SEEDS)]
    t0 = time.perf_counter()
    images = seed_matched_protocol(
        lambda p, s: pipe.text2image(p, seed=s, height=EVAL_PX,
                                     width=EVAL_PX), prompts, seeds)
    gen_s = time.perf_counter() - t0
    texts = [p for p in prompts for _ in seeds]
    px = clip_pixels(images)
    f32, bf16 = clip_scorers(seed)
    feats, counts, ms, graph, scores = {}, {}, {}, {}, {}
    for name, scorer in (("bf16", bf16), ("f32", f32)):
        scorer.image_features(px)                     # warm-up
        torch.cuda.synchronize()
        reset_counts()
        feats[name] = scorer.image_features(px)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        scores[name] = scorer.clip_t(px, texts)
        ms[name] = call_ms(lambda s=scorer: s.image_features(px), iters=5)
        graph[name] = graph_step_times(
            lambda s=scorer: s.image_features(px))
    cos = (feats["bf16"] * feats["f32"]).sum(-1).cpu().numpy()
    by_seed = [feats["f32"][i::EVAL_SEEDS].double().cpu().numpy()
               for i in range(EVAL_SEEDS)]
    fid = frechet_distance(*by_seed)
    fid_self = frechet_distance(by_seed[0], by_seed[0].copy())
    kernel = {"bf16": "flash_fwd", "f32": "flash_fwd_f32"}
    k1b = {n: c[kernel[n]] for n, c in counts.items()}
    others = {n: sum(v for k, v in c.items() if k != kernel[n])
              for n, c in counts.items()}
    rec = {"phase": "eval", "images": list(images.shape),
           "prompts": len(prompts), "seeds": seeds, "generate_s": gen_s,
           "clip_t_bf16": scores["bf16"].tolist(),
           "clip_t_f32": scores["f32"].tolist(),
           "clip_t_max_abs_diff": float(np.abs(scores["bf16"]
                                               - scores["f32"]).max()),
           "feature_cosine_bf16_f32": cos.tolist(),
           "frechet_seed0_seed1": fid, "frechet_self": fid_self,
           "k1_launches": k1b, "other_launches": others,
           "image_features_ms": ms, "image_features_graph": graph,
           "batch": int(px.shape[0]), "card": card}
    emit(rec)
    if not (k1b == {"bf16": 24, "f32": 24} and others == {"bf16": 0,
                                                          "f32": 0}
            and cos.min() >= 0.99 and rec["clip_t_max_abs_diff"] <= 0.3
            and math.isfinite(fid) and fid >= 0 and abs(fid_self) <= 1e-6
            and images.dtype == np.uint8
            and images.shape == (4, EVAL_PX, EVAL_PX, 3)):
        raise AssertionError(f"the eval phase is wrong: {rec}")
    return {k: counts["bf16"][k] + counts["f32"][k] for k in counts["bf16"]}


def draw_bank(seed: int):
    """LightControl's bank at ``ControlNeXtConfig()`` (19 branches of 128 /
    256 channels, 3072 out, bf16), drawn on the card from the seed: ->
    (its config, the bank)."""
    import torch
    from x2i_torch.core.config import ControlNeXtConfig, LightControlConfig
    from x2i_torch.models.controlnext import ControlBank
    from x2i_torch.params import random_init_

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    cfg = ControlNeXtConfig()
    return cfg, random_init_(ControlBank(cfg, LightControlConfig(
        ).num_controls, torch.device("cuda")), g)


def control_image(seed: int, px: int = 1024):
    """A guidance image: uint8 (1, px, px, 3) drawn on the card from the
    seed, through ``preprocess`` to [-1, 1]."""
    import torch
    from x2i_torch.models.vae import preprocess
    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    return preprocess(torch.randint(0, 256, (1, px, px, 3), generator=g,
                                    device="cuda", dtype=torch.uint8))


def branch_flops(branch, pixels, timestep) -> int:
    """The operations (2 x multiply-adds) of one branch's convolutions and
    Linears on these inputs, from their output shapes on one call."""
    import torch
    from torch import nn
    flops = []

    def count(mod, _, out):
        per_out = (mod.weight[0].numel() if isinstance(mod, nn.Conv2d)
                   else mod.in_features)
        flops.append(2 * per_out * out.numel())

    hooks = [m.register_forward_hook(count) for m in branch.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.inference_mode():
            branch(pixels, timestep)
    finally:
        for h in hooks:
            h.remove()
    return sum(flops)


def control_timing(bank, pixels, timestep) -> dict:
    """The bank's cost at one denoise step: ``control_ms`` = 19 x one
    branch's device time (``kernel_ms``: the bank's some 2,500 launches a
    call overflow the launch queue that ``kernel_ms`` fills), the bank's
    call with its host path (``call_ms``), and the bound: each branch's
    operations at the bf16 peak, or the bytes of its pixels, weights and
    tokens, whichever is larger."""
    import torch
    br, n = bank.branches[0], len(bank.branches)
    with torch.inference_mode():
        branch_ms = kernel_ms(lambda p, t: br(p, t), pixels, timestep,
                              iters=5)
        bank_call_ms = call_ms(lambda: bank(pixels, timestep), iters=3)
        out = br(pixels, timestep)
    flops = branch_flops(br, pixels, timestep)
    moved = nbytes(pixels, out, *br.parameters())
    b_ms, basis = bound(flops, moved)
    return {"control_ms": n * branch_ms, "branch_ms": branch_ms,
            "control_call_ms": bank_call_ms, "control_bound_ms": n * b_ms,
            "control_bound_by": basis, "branch_flops": flops,
            "bank_weight_bytes": _weight_bytes(bank)}


def phase_lightcontrol(pipe, bf16_pixels, seed: int, card: str):
    """LightControl serving on the bf16 pipeline: the bank (``draw_bank``)
    attached with ``with_controls``, a 1024^2 guidance image
    (``control_image``); one 4-step text2image with ``control_pixels``
    after one warm-up, launch counts exact and those of the text image
    (the bank's convolutions and GroupNorms are cuDNN and PyTorch's: no
    kernel of this repo), s/image, peak memory and the bank's time
    (``control_timing``); its pixels against the text image's (they
    differ); with every branch's out conv zeroed, the image bit for bit
    the pipeline's without controls; the 2 + 2-block route check with the
    bank's controls. -> (launches, (config, bank, guidance image))."""
    import numpy as np
    import torch

    cfg, bank = draw_bank(seed)
    cpipe = pipe.with_controls(cfg, bank)
    guide = control_image(seed)
    want = expected_launches(False, 4)
    rec, pixels, counts = run_image(cpipe, seed, "lightcontrol", want,
                                    control_pixels=guide)
    sig0 = pipe.scheduler.inference_sigmas(4, image_seq_len=4096,
                                           device=guide.device)[:1]
    rec.update(control_timing(bank, guide, sig0 * 1000.0), card=card)
    ref = bf16_pixels.float()
    rec["rel_l2_vs_no_controls"] = ((pixels.float() - ref).norm()
                                    / ref.norm()).item()

    req = {"task": "text2image", "prompt": PROMPTS[0], "seed": seed,
           "height": 1024, "width": 1024, "num_steps": 4}
    saved = [(br.out_conv.weight.clone(), br.out_conv.bias.clone())
             for br in bank.branches]
    with torch.no_grad():
        for br in bank.branches:
            br.out_conv.weight.zero_()
            br.out_conv.bias.zero_()
    zero_img = cpipe.run_task(**req, control_pixels=guide)
    with torch.no_grad():
        for br, (w, b) in zip(bank.branches, saved):
            br.out_conv.weight.copy_(w)
            br.out_conv.bias.copy_(b)
    del saved
    plain_img = pipe.run_task(**req)
    rec["zero_bank_equals_no_controls"] = bool(np.array_equal(zero_img,
                                                              plain_img))
    emit(rec)
    if (counts != want or not rec["zero_bank_equals_no_controls"]
            or not rec["rel_l2_vs_no_controls"] > 0):
        raise AssertionError(f"the controlled image is wrong: {rec} "
                             f"(launches expected {want})")
    check_routes(seed + 4, label="lightcontrol-reference", bank=bank)
    return counts, (cfg, bank, guide)


# per phase-2 step: the frozen DiT's forward and its recompute under remat
# (K1 with the lse) and its backward (K3, K4) in every block but the first
# double block, whose attention no gradient reaches (the first control is
# added after it), so that it runs the forward-only no-rope body once
# (K1c); the imagetext2image conditioning (K1b in the 24 ViT and the 24
# LM layers); the bank and the VAE encoder launch no kernel of this repo;
# no glue kernel, no GEMM
LIGHTCONTROL_LAUNCHES = dict(NO_LAUNCHES, flash_fwd_pipe=1,
                             flash_fwd_lse=112, flash_bwd_dq=56,
                             flash_bwd_dkv=56, flash_fwd=48)


def timed(fn, sections: dict, key: str):
    """``fn`` timed into ``sections[key]`` (seconds, the card synchronized
    before and after)."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sections[key] = sections.get(key, 0.0) + time.perf_counter() - t0
        return out
    return run


def param_checksum(module):
    """Per parameter and buffer, the sum of its bytes (int64): a change of
    any value changes its sum but by chance."""
    import torch
    return [t.detach().contiguous().view(torch.uint8).sum(
        dtype=torch.int64).item()
        for t in (*module.parameters(), *module.buffers())]


def phase_lightcontrol_train(pipe, lm, seed: int, card: str):
    """The phase-2 LightControl step at full width and depth, batch 1,
    bf16, on the pipeline's DiT, VAE, LM and proj (the DiT set to the
    trainer's config, ``TRAIN_DIT``, and set back after), InternViT drawn
    again for the conditioning: an imagetext2image request (an
    instruction and a condition image). LightControlConfig defaults
    (the bank under "scan") except gradient_accumulation_steps=1; the
    target a 1024^2 image drawn from the seed through the sampled VAE
    encode (4096 image tokens). One warm-up and three timed steps, every
    launch count set to 0 just before each step and read just after,
    each step split into the VAE encode, the conditioning, the optimizer
    and the rest (the bank and the DiT, forward and backward). Checks:
    loss and grad norm finite, grad norm > 0, the bank changed by every
    step, the DiT's parameters bit for bit those before the steps (a
    checksum), the launch counts exact; then the 2 + 2-block gradient
    route check (``check_lightcontrol_routes``)."""
    import gc

    import torch
    from x2i_torch.convert.load import mllm_encoder
    from x2i_torch.core.config import LightControlConfig
    from x2i_torch.pipeline import X2IPipeline
    from x2i_torch.train.harness import build_random_lightcontrol
    from x2i_torch.train.lightcontrol import make_lightcontrol_step
    from x2i_torch.train.runner import step_noise

    t0 = time.perf_counter()
    tok = ByteTokenizer("internvl")
    vision = draw_internvl(MODEL, lm, seed, tok)
    entry = X2IPipeline(
        encoder_fn=mllm_encoder(MODEL, lm, tok, vision.cfg, vision),
        proj=pipe.proj, flux=pipe.flux, vae=pipe.vae,
        scheduler=pipe.scheduler, gen_cfg=pipe.gen_cfg)
    images, route = media("internvl", seed, 1)
    request = {"task": "imagetext2image", "prompt": "make the sky stormy",
               "images": images}
    _, state, batch, parts = build_random_lightcontrol(
        "full", seed, pipe=entry, request=request,
        ccfg=LightControlConfig(gradient_accumulation_steps=1))
    sections = {}
    opt = parts["optimizer"]
    opt.update = timed(opt.update, sections, "optimizer_s")
    step = make_lightcontrol_step(
        parts["flux"], timed(parts["vae_encode"], sections, "vae_encode_s"),
        timed(parts["conditioning_fn"], sections, "conditioning_s"),
        parts["flux_cfg"], parts["ccfg"], parts["sched_cfg"], opt)
    checksum = param_checksum(pipe.flux)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps = []
    for i in range(4):
        before = [p.detach().clone() for p in state.bank.parameters()]
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        sections.clear()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, step_noise(seed, i))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_s = time.perf_counter() - t0
        counts = launch_counts()
        moved = sum(int((p.detach() != b).sum()) for p, b in
                    zip(state.bank.parameters(), before))
        rec = {"phase": "lightcontrol-train", "step": i + 1,
               "warmup": i == 0, "step_s": step_s, **sections,
               "bank_dit_fwd_bwd_s": step_s - sum(sections.values()),
               "loss": loss, "grad_norm": gnorm,
               "bank_values_moved": moved, "launches": counts}
        emit(rec)
        steps.append(rec)
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
                and moved > 0 and counts == LIGHTCONTROL_LAUNCHES):
            raise AssertionError(
                f"LightControl step {i + 1} is wrong: {rec} (launches "
                f"expected {LIGHTCONTROL_LAUNCHES})")
    timed_steps = steps[1:]
    keys = ("step_s", "vae_encode_s", "conditioning_s", "bank_dit_fwd_bwd_s",
            "optimizer_s")
    summary = {"phase": "lightcontrol-train-summary", "model": MODEL,
               "px": 1024, "tokens": [4096, 512], "batch": 1,
               "bank_impl": parts["ccfg"].control_bank_impl,
               "host_half": route, "build_s": build_s,
               **{k: statistics.mean(r[k] for r in timed_steps)
                  for k in keys},
               "steps_s": [r["step_s"] for r in timed_steps],
               "bank_values": sum(p.numel() for p in
                                  state.bank.parameters()),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "dit_unchanged": param_checksum(pipe.flux) == checksum,
               "launches_per_step": LIGHTCONTROL_LAUNCHES, "card": card}
    emit(summary)
    if not summary["dit_unchanged"]:
        raise AssertionError(f"the frozen DiT changed: {summary}")
    del state, parts, batch, step, opt, entry, vision
    pipe.flux.replace_config(remat=False, rope_in_kernel=True,
                             fused_glue=True)
    gc.collect()
    torch.cuda.empty_cache()
    check_lightcontrol_routes(seed)
    return steps[-1]["launches"], summary


def check_lightcontrol_routes(seed: int, dtype: str = "bf16"):
    """The controls' gradient of a flow-matching MSE on a full-width DiT
    cut to 2 double + 2 single blocks, at the training point (4096 image +
    512 text tokens), the trainer's config, through the kernel route (K1c
    in the first double block, K1 with the lse, K3 and K4 after it) and
    through the plain attention on the same bf16 weights, controls and
    target: bf16 accuracy, as ``check_distill_routes`` holds it:
    correlation above 0.99, relative L2 error below 5e-2. ``dtype="f32"``:
    the DiT, the controls and the target in f32, the kernel route the f32
    instances (K1's forward in the first double block, K1 with the lse, K3
    and K4 after it), held to the same bar (their operands are rounded to
    bf16 where the bf16 kernels round them)."""
    import dataclasses

    import torch
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.params import random_init_
    from x2i_torch.train.harness import TRAIN_DIT

    dev = torch.device("cuda")
    f32 = dtype == "f32"
    dt = torch.float32 if f32 else torch.bfloat16
    base = dataclasses.replace(MODEL_REGISTRY[MODEL].flux, num_layers=2,
                               num_single_layers=2, dtype=dt, **TRAIN_DIT)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    kern = random_init_(FluxTransformer2D(base, dev), g).requires_grad_(False)
    plain = FluxTransformer2D(dataclasses.replace(
        base, attention_impl="plain"), dev).requires_grad_(False)
    plain.load_state_dict(kern.state_dict())

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    args = (rnd(1, 4096, 64), rnd(1, 512, 4096), rnd(1, 768),
            torch.full((1,), 0.6, device=dev),
            prepare_latent_image_ids(128, 128, dev),
            torch.zeros((512, 3), device=dev))
    controls, target = (0.1 * rnd(2, 1, 4096, 3072)).to(dt), rnd(
        1, 4096, 64).float()

    def grads(model):
        c = controls.clone().requires_grad_()
        pred = model(*args, controls=c)
        (pred.float() - target).square().mean().backward()
        return c.grad.float().flatten()

    reset_counts()
    got = grads(kern)
    used = launch_counts()
    reset_counts()
    want = grads(plain)
    used_plain = launch_counts()
    rel = ((got - want).norm() / want.norm()).item()
    corr = torch.corrcoef(torch.stack([got, want]))[0, 1].item()
    sfx = "_f32" if f32 else ""
    want_used = dict(NO_LAUNCHES, **{
        "flash_fwd_f32" if f32 else "flash_fwd_pipe": 1,
        f"flash_fwd_lse{sfx}": 6, f"flash_bwd_dq{sfx}": 3,
        f"flash_bwd_dkv{sfx}": 3})
    rec = {"phase": "lightcontrol-train-reference" + ("-f32" if f32 else ""),
           "blocks": [2, 2], "dtype": dtype,
           "tokens": [4096, 512], "grad_rel_l2_err": rel, "grad_corr": corr,
           "grad_norm": want.norm().item(),
           "finite": bool(torch.isfinite(got).all()),
           "kernel_launches": used, "kernel_launches_expected": want_used,
           "plain_route_launches": used_plain}
    emit(rec)
    if not (rec["finite"] and corr > 0.99 and rel < 5e-2
            and used == want_used and not any(used_plain.values())):
        raise AssertionError(f"the LightControl gradient's kernel route "
                             f"disagrees with the plain route: {rec}")


# ------------------------------------------------------------ train-resume

# JAX's single-chip phase-1 operating point (x2i_tpu/train/single_chip.py):
# a w8a8 DiT, inline KD, int8 KD stacks, 8-bit AdamW; per step the flash
# kernels of the bf16 step and the quantized DiT's (see
# quantized_step_launches)
TRAIN_RESUME_LAUNCHES = dict(DISTILL_LAUNCHES,
                             **quantized_step_launches(19, 38)[1])
# a phase-2 step on a quantized DiT with a text2image conditioning (K1b in
# the LM's 24 layers only)
LIGHTCONTROL_W8A8_LAUNCHES = dict(LIGHTCONTROL_LAUNCHES, flash_fwd=24,
                                  **quantized_step_launches(19, 38)[2])
LIGHTCONTROL_W4A8_LAUNCHES = dict(
    LIGHTCONTROL_LAUNCHES, flash_fwd=24,
    **quantized_step_launches(19, 38, "w4a8")[2])
LIGHTCONTROL_W4_LAUNCHES = dict(
    LIGHTCONTROL_LAUNCHES, flash_fwd=24,
    **quantized_step_launches(19, 38, "w4")[2])
RESUME_STEPS, RESUME_AT = 4, 2


def _repeat(batch):
    while True:
        yield batch


def _tree_bytes_equal(a, b) -> bool:
    """Two ``checkpointing.to_tree`` trees equal bit for bit (tensors
    compared as bytes, so that -0 and 0, or two NaNs, are told apart)."""
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_bytes_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_tree_bytes_equal, a, b))
    return a == b


def _tree_max_diff(a, b) -> float:
    """The largest absolute difference between two trees' float tensors."""
    import torch
    if isinstance(a, torch.Tensor):
        return (a.float() - b.float()).abs().max().item() if a.numel() \
            else 0.0
    if isinstance(a, dict):
        return max([_tree_max_diff(a[k], b[k]) for k in a] or [0.0])
    if isinstance(a, list):
        return max([_tree_max_diff(x, y) for x, y in zip(a, b)] or [0.0])
    return 0.0 if a == b else math.inf


def phase_train_resume(pipe, lm, seed: int, card: str):
    """Training runs that resume, at JAX's single-chip phase-1 operating
    point: the pipeline's DiT quantized in place to w8a8
    (``quantize_module_``, as the w8a8 image then uses it) in the
    trainer's config, the same LM, T5-XXL and CLIP-L drawn on the card,
    ``DistillConfig(inline_kd, kd_stacks_int8, use_8bit_adam,
    lr_warmup_steps=1)``, batch 1, 128 x 128 latents, each step teacher
    then student through ``TrainLoop`` with checkpoints every 2 steps in
    a temporary directory. Run A: 4 steps unbroken, every launch count
    set to 0 just before each step and read just after (exact), s/step
    (steps 2-4), the teacher's and the student's s, peak memory after the
    first step. Run B: from the same initial state 2 steps, then a new
    TrainLoop on its directory, which must log the resume at step 2, to
    step 4: the proj and the 8-bit optimizer state bit for bit run A's
    (if they were not, a second unbroken run A' would set the bar: B no
    further from A than A' is). Then the w8a8 gradient route check, the
    phase-2 step with 8-bit AdamW on the same w8a8 DiT
    (``phase_lightcontrol_steps``) and the training command line
    (``check_train_cli``). -> (run A's last launches, the quantize s, the
    phase-2 launches)."""
    import gc
    import logging
    import os
    import tempfile

    import torch
    from x2i_torch.core.checkpointing import fill, to_tree
    from x2i_torch.core.config import DistillConfig
    from x2i_torch.ops.quant import quantize_module_
    from x2i_torch.train.harness import build_random_distill
    from x2i_torch.train.optim8bit import state_bytes
    from x2i_torch.train.runner import TrainLoop

    t0 = time.perf_counter()
    quantize_module_(pipe.flux, "w8a8")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quantize_s = time.perf_counter() - t0
    dcfg = DistillConfig(inline_kd=True, kd_stacks_int8=True,
                         use_8bit_adam=True, lr_warmup_steps=1)
    t0 = time.perf_counter()
    (teacher_fn, student_fn), state, batch, parts = build_random_distill(
        "full", seed, flux=pipe.flux, lm=lm, dcfg=dcfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sections = {}
    teacher = timed(teacher_fn, sections, "teacher_s")
    student = timed(student_fn, sections, "student_s")

    def step_fn(st, b, noise):
        return student(st, b, teacher(b, noise), noise)

    run = {"name": "A"}
    steps = []

    def on_metrics(step, metrics):
        counts = launch_counts()
        rec = {"phase": "train-resume", "run": run["name"], "step": step + 1,
               **sections, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": parts["optimizer"].learning_rate(step),
               "launches": counts}
        emit(rec)
        steps.append(rec)
        if run["name"] == "A" and step == 0:
            torch.cuda.reset_peak_memory_stats()
        sections.clear()
        reset_counts()
        if not (math.isfinite(rec["loss"]) and rec["grad_norm"] > 0
                and math.isfinite(rec["grad_norm"])
                and counts == TRAIN_RESUME_LAUNCHES):
            raise AssertionError(f"w8a8 training step {step + 1} is wrong: "
                                 f"{rec} (launches expected "
                                 f"{TRAIN_RESUME_LAUNCHES})")

    said = []
    grab = logging.Handler()
    grab.emit = lambda r: said.append(r.getMessage())
    logger = logging.getLogger("x2i_torch.train")
    logger.addHandler(grab)
    logger.setLevel(logging.INFO)
    init = to_tree(state)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def loop(name, directory):
                run["name"] = name
                sections.clear()
                reset_counts()
                return TrainLoop(step_fn, fill(state, init), _repeat(batch),
                                 seed=seed, on_metrics=on_metrics,
                                 checkpoint_dir=os.path.join(tmp, directory),
                                 checkpointing_steps=RESUME_AT)

            a = loop("A", "A")
            out_a = a.run(RESUME_STEPS)
            peak = torch.cuda.max_memory_allocated()
            tree_a = to_tree(a.state)
            opt_bytes = state_bytes(a.state.opt_state)
            ckpt_bytes = sum(
                os.path.getsize(os.path.join(tmp, "A", str(RESUME_STEPS), f))
                for f in os.listdir(os.path.join(tmp, "A",
                                                 str(RESUME_STEPS))))
            del a
            loop("B", "B").run(RESUME_AT)
            said.clear()
            b = loop("B", "B")
            resumed_at = b.state.step
            b.run(RESUME_STEPS)
            tree_b = to_tree(b.state)
            del b
            bit_for_bit = _tree_bytes_equal(tree_a, tree_b)
            bar = None
            if not bit_for_bit:
                a2 = loop("A'", "A2")
                a2.run(RESUME_STEPS)
                bar = _tree_max_diff(to_tree(a2.state), tree_a)
                del a2
    finally:
        logger.removeHandler(grab)
    timed_a = [r for r in steps if r["run"] == "A"][1:]
    n_params = sum(p.numel() for p in state.proj.parameters())
    summary = {"phase": "train-resume-summary", "model": MODEL,
               "quantized": "w8a8", "inline_kd": True,
               "kd_stacks_int8": True, "use_8bit_adam": True,
               "latents": [128, 128], "tokens": [4096, 512], "batch": 1,
               "quantize_s": quantize_s, "build_s": build_s,
               "s_per_step": out_a["timing"]["mean_s"],
               "steps_s": [r["teacher_s"] + r["student_s"]
                           for r in timed_a],
               "teacher_s": statistics.mean(r["teacher_s"] for r in timed_a),
               "student_s": statistics.mean(r["student_s"] for r in timed_a),
               "max_memory_allocated": peak,
               "launches_per_step": TRAIN_RESUME_LAUNCHES,
               "proj_values": n_params, "opt_state_bytes": opt_bytes,
               "opt_state_bytes_two_f32_moments": 8 * n_params,
               "checkpoint_bytes": ckpt_bytes,
               "resumed_at_step": resumed_at,
               "resume_logged": f"resumed from step {RESUME_AT}" in said,
               "resume_bit_for_bit": bit_for_bit,
               "resume_max_abs_diff": (0.0 if bit_for_bit else
                                       _tree_max_diff(tree_a, tree_b)),
               "unbroken_rerun_max_abs_diff": bar, "card": card}
    emit(summary)
    if not (resumed_at == RESUME_AT and summary["resume_logged"]
            and (bit_for_bit or summary["resume_max_abs_diff"] <= bar)):
        raise AssertionError(f"the resumed run is not the unbroken one: "
                             f"{summary}")
    launches = [r for r in steps if r["run"] == "A"][-1]["launches"]
    del state, parts, batch, teacher_fn, student_fn, teacher, student
    del tree_a, tree_b, init
    pipe.flux.replace_config(remat=False, rope_in_kernel=True,
                             fused_glue=True)
    gc.collect()
    torch.cuda.empty_cache()
    check_distill_routes(seed, "w8a8")
    lc_launches = phase_lightcontrol_steps(
        pipe, seed, card, "lightcontrol-train-w8a8",
        LIGHTCONTROL_W8A8_LAUNCHES, steps=3, use_8bit_adam=True)
    check_train_cli()
    return launches, quantize_s, lc_launches


def phase_lightcontrol_steps(pipe, seed: int, card: str, label: str,
                             want: dict, steps: int, use_8bit_adam: bool):
    """The phase-2 step at full width on the pipeline's DiT as it stands
    (quantized, or in f32; the trainer's config, set back after), VAE, LM
    and proj, with AdamW in 8 bits or 32 (``LightControlConfig(
    use_8bit_adam)``, no accumulation), the 19-branch bank drawn on the
    card in the DiT's dtype and a text2image conditioning: one warm-up and
    ``steps - 1`` timed steps, every launch count set to 0 just before each
    step and read just after (exact: ``want``), each split into the VAE
    encode, the conditioning, the optimizer and the rest. Checks: loss and
    grad norm finite, grad norm > 0, the bank moved by every step, the
    DiT's parameters bit for bit those before the steps (a checksum). ->
    the last step's launches."""
    import gc

    import torch
    from x2i_torch.core.config import LightControlConfig
    from x2i_torch.train.harness import build_random_lightcontrol
    from x2i_torch.train.lightcontrol import make_lightcontrol_step
    from x2i_torch.train.optim8bit import state_bytes
    from x2i_torch.train.runner import step_noise

    t0 = time.perf_counter()
    checksum = param_checksum(pipe.flux)
    _, state, batch, parts = build_random_lightcontrol(
        "full", seed, pipe=pipe, ccfg=LightControlConfig(
            gradient_accumulation_steps=1, use_8bit_adam=use_8bit_adam))
    sections = {}
    opt = parts["optimizer"]
    opt.update = timed(opt.update, sections, "optimizer_s")
    step = make_lightcontrol_step(
        parts["flux"], timed(parts["vae_encode"], sections, "vae_encode_s"),
        timed(parts["conditioning_fn"], sections, "conditioning_s"),
        parts["flux_cfg"], parts["ccfg"], parts["sched_cfg"], opt)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    recs = []
    for i in range(steps):
        before = [p.detach().clone() for p in state.bank.parameters()]
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        sections.clear()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, step_noise(seed, i))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_s = time.perf_counter() - t0
        counts = launch_counts()
        moved = sum(int((p.detach() != b).sum()) for p, b in
                    zip(state.bank.parameters(), before))
        rec = {"phase": label, "step": i + 1, "warmup": i == 0,
               "step_s": step_s, **sections,
               "bank_dit_fwd_bwd_s": step_s - sum(sections.values()),
               "loss": loss, "grad_norm": gnorm,
               "bank_values_moved": moved, "launches": counts}
        emit(rec)
        recs.append(rec)
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
                and moved > 0 and counts == want):
            raise AssertionError(f"{label} step {i + 1} is wrong: {rec} "
                                 f"(launches expected {want})")
    timed_steps = recs[1:]
    keys = ("step_s", "vae_encode_s", "conditioning_s", "bank_dit_fwd_bwd_s",
            "optimizer_s")
    bank_values = sum(p.numel() for p in state.bank.parameters())
    summary = {
        "phase": f"{label}-summary", "model": MODEL, "px": 1024,
        "quantized": parts["flux_cfg"].quantized,
        "dtype": str(parts["flux_cfg"].dtype),
        "use_8bit_adam": use_8bit_adam, "batch": 1, "build_s": build_s,
        **{k: statistics.mean(r[k] for r in timed_steps) for k in keys},
        "steps_s": [r["step_s"] for r in timed_steps],
        "bank_values": bank_values,
        "opt_state_bytes": state_bytes(state.opt_state),
        "opt_state_bytes_bf16_moments": 4 * bank_values,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "dit_unchanged": param_checksum(pipe.flux) == checksum,
        "launches_per_step": want, "card": card}
    emit(summary)
    if not summary["dit_unchanged"]:
        raise AssertionError(f"the frozen DiT changed: {summary}")
    del state, parts, batch, step, opt
    pipe.flux.replace_config(remat=False, rope_in_kernel=True,
                             fused_glue=True)
    gc.collect()
    torch.cuda.empty_cache()
    return recs[-1]["launches"]


def check_train_cli():
    """``python -m x2i_torch.train.cli`` on the card (its default device)
    in subprocesses, as a user starts a run: ``distill --tiny --synthetic``
    for 4 steps with checkpoints every 2, then again to 6 steps on the
    same output directory, which must resume from step 4; the
    ``lightcontrol --tiny`` subcommand for 2 steps beside the first. Each
    must exit 0 and leave its last step's directory."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))

    def start(*args):
        return subprocess.Popen(
            [sys.executable, "-m", "x2i_torch.train.cli", *args], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    procs = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out_d, out_lc = os.path.join(tmp, "distill"), os.path.join(
                tmp, "lc")
            distill = ("distill", "--tiny", "--synthetic",
                       "--checkpointing_steps", "2", "--output_dir", out_d)
            procs.append(start("lightcontrol", "--tiny", "--max_train_steps",
                               "2", "--output_dir", out_lc))
            procs.append(start(*distill, "--max_train_steps", "4"))
            first = procs[-1].communicate(timeout=300)
            procs.append(start(*distill, "--max_train_steps", "6"))
            second = procs[-1].communicate(timeout=300)
            lc = procs[0].communicate(timeout=300)
            rec = {"phase": "train-cli", "seconds": time.perf_counter() - t0,
                   "exit_codes": [p.returncode for p in procs],
                   "distill_steps": sorted(os.listdir(out_d)),
                   "lightcontrol_steps": sorted(os.listdir(out_lc)),
                   "resumed_from_step_4": "resumed from step 4" in second[1],
                   "final": [o[0].strip().splitlines()[-1:]
                             for o in (first, second, lc)]}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    emit(rec)
    if not (rec["exit_codes"] == [0, 0, 0] and rec["resumed_from_step_4"]
            and "6" in rec["distill_steps"]
            and "2" in rec["lightcontrol_steps"]):
        raise AssertionError(f"the training command line failed: {rec}\n"
                             f"{first[1][-2000:]}\n{second[1][-2000:]}\n"
                             f"{lc[1][-2000:]}")


def phase_f32_quant(pipe, mode_pixels, seed: int, card: str, mode: str):
    """The serving DiT in ``mode`` (w8a8 or w4a8) cast in place to f32
    (``set_dit_dtype``: its floating parameters and its layers' dtype; the
    codes and scales stay), the LM bf16: the same 1024^2, 4-step
    text2image with the glue unfused (one K8 a dense call), then with
    ``fused_glue=True`` once as the warm-up and once timed (K6, K7 and K8
    on f32 rows, the GEMM's f32 epilogue, K1's f32 rope-and-norm
    instance), each with every launch count set to 0 just before and read
    just after (exact), the timed one's s/image and peak memory, its
    relative L2 distance from the unfused f32 image (at most 2e-2, as
    ``f32-fused`` holds) and from the bf16 image of the mode
    (``mode_pixels``, reported); then the DiT cast back to bf16 in its
    serving config, bit for bit the one before (a checksum), and the
    2 + 2-block f32 route check of the mode. -> {run label: launches}."""
    import numpy as np
    import torch
    from x2i_torch.models.vae import postprocess

    px, flux = F32_FUSED_PX, pipe.flux
    checksum = param_checksum(flux)
    serving = flux.cfg.fused_glue
    t0 = time.perf_counter()
    set_dit_dtype(flux, torch.float32)
    _free()
    cast_s = time.perf_counter() - t0
    label = f"f32-{mode}"
    runs, images, secs = {}, {}, {}
    try:
        for run, fused in ((f"{label}-unfused", False),
                           (f"{label}-warm-up", True), (label, True)):
            flux.replace_config(fused_glue=fused)
            want = expected_launches(mode, 4, dtype="f32", f32_fused=fused)
            if run == label:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            images[run] = pipe.text2image(PROMPTS[0], seed=seed, height=px,
                                          width=px, num_steps=4)
            secs[run] = time.perf_counter() - t0
            runs[run] = launch_counts()
            if runs[run] != want:
                raise AssertionError(f"the {run} image missed its kernels: "
                                     f"{runs[run]} != {want}")
        peak = torch.cuda.max_memory_allocated()
    finally:
        set_dit_dtype(flux, torch.bfloat16)
        flux.replace_config(fused_glue=serving)
        _free()
    restored = param_checksum(flux) == checksum
    got = images[label].astype(np.float32)
    unfused = images[f"{label}-unfused"].astype(np.float32)
    ref = postprocess(mode_pixels).float().cpu().numpy()
    rec = {"phase": label, "model": MODEL, "px": px, "steps": 4,
           "dtype": "float32", "quantized": mode, "fused_glue": True,
           "cast_s": cast_s, "s_per_image": secs[label],
           "warmup_s": secs[f"{label}-warm-up"],
           "s_per_image_unfused": secs[f"{label}-unfused"],
           "rel_l2_vs_unfused_image": float(np.linalg.norm(got - unfused)
                                            / np.linalg.norm(unfused)),
           "rel_l2_vs_bf16_image": float(np.linalg.norm(got - ref)
                                         / np.linalg.norm(ref)),
           "image_shape": list(images[label].shape),
           "pixels_std": float(images[label].std()),
           "max_memory_allocated": peak, "bf16_restored": restored,
           "launches": runs[label],
           "launches_unfused": runs[f"{label}-unfused"], "card": card}
    emit(rec)
    if not (rec["rel_l2_vs_unfused_image"] <= 2e-2 and restored
            and rec["pixels_std"] > 0
            and tuple(images[label].shape) == (1, px, px, 3)):
        raise AssertionError(f"the {label} image is wrong: {rec}")
    return {label: runs[label],
            f"{label}-reference": check_routes_quant(seed, mode, "f32")}


def phase_w8a8(pipe, bf16_pixels, seed: int, control, quant_s: float,
               card: str):
    """The DiT quantized in place to w8a8 by ``phase_train_resume`` (its
    bf16 weights freed layer by layer in ``quant_s``; LM, proj and VAE
    stay bf16) makes the same image; then the same image with
    LightControl's ``control`` = (config, bank, guidance image) of
    ``phase_lightcontrol``, with the same counts; then the same DiT in f32
    (``phase_f32_quant``). -> (the launches of each, {f32 run label:
    launches})."""
    want = expected_launches("w8a8", 4)
    rec, pixels, counts = run_image(pipe, seed, "text2image-w8a8", want)
    ref = bf16_pixels.float()
    rec["quantize_s"] = quant_s
    rec["rel_l2_vs_bf16"] = ((pixels.float() - ref).norm()
                             / ref.norm()).item()
    emit(rec)
    if counts != want:
        raise AssertionError(f"w8a8 main path missed its kernels: {counts} "
                             f"!= {want}")
    check_routes_quant(seed, "w8a8")
    cfg, bank, guide = control
    crec, cpixels, ccounts = run_image(pipe.with_controls(cfg, bank), seed,
                                       "lightcontrol-w8a8", want,
                                       control_pixels=guide)
    crec["rel_l2_vs_no_controls"] = ((cpixels.float() - pixels.float()).norm()
                                     / pixels.float().norm()).item()
    emit(crec)
    if ccounts != want or not crec["rel_l2_vs_no_controls"] > 0:
        raise AssertionError(f"the w8a8 controlled image is wrong: {crec} "
                             f"(launches expected {want})")
    return counts, ccounts, phase_f32_quant(pipe, pixels, seed, card,
                                            "w8a8")


def phase_quant(pipe, bf16_pixels, seed: int, dit_state, mode: str,
                card: str):
    """The bf16 DiT drawn again from its generator state (the quantized
    one before it freed first), quantized in place to ``mode`` ("w4a8",
    "w4" or "w8"), then the same image as the bf16 one; the 2 + 2-block
    route check in the mode; then in f32: in w4a8 the images of
    ``phase_f32_quant``, in w4 and w8 the 2 + 2-block f32 route check (the
    f32 dequantize kernel before ``F.linear``). -> (the launches, {f32
    run label: launches})."""
    import gc

    import torch
    from x2i_torch.ops.quant import quantize_module_

    pipe.flux = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flux = quantize_module_(draw_dit(dit_state)[0], mode)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    quant_s = time.perf_counter() - t0
    pipe.flux = flux
    want = expected_launches(mode, 4)
    rec, pixels, counts = run_image(pipe, seed, f"text2image-{mode}", want)
    ref = bf16_pixels.float()
    rec["draw_and_quantize_s"] = quant_s
    rec["rel_l2_vs_bf16"] = ((pixels.float() - ref).norm()
                             / ref.norm()).item()
    emit(rec)
    if counts != want:
        raise AssertionError(f"{mode} main path missed its kernels: "
                             f"{counts} != {want}")
    check_routes_quant(seed, mode)
    if mode == "w4a8":
        return counts, phase_f32_quant(pipe, pixels, seed, card, mode)
    return counts, {f"f32-{mode}-reference": check_routes_quant(seed, mode,
                                                                "f32")}


def phase_serve(pipe):
    from concurrent.futures import ThreadPoolExecutor

    server = pipe.serving_server(batch_size=2, max_wait_s=1.0,
                                 buckets=[1, 2], height=512, width=512)
    sizes = []
    run = server.generate_batch

    def counted(reqs):
        sizes.append(len(reqs))
        return run(reqs)

    server.generate_batch = counted
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(server.generate, {"prompt": p}, 600)
                    for p in PROMPTS[1:]]
            images = [f.result() for f in futs]
    finally:
        server.close()
    rec = {"phase": "serve", "requests": len(images),
           "shapes": [list(i.shape) for i in images], "batches": sizes,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if (len(images) != 3 or sizes != [2, 1]
            or any(i.shape != (512, 512, 3) for i in images)):
        raise AssertionError(f"serving answered wrongly: {rec}")


# ------------------------------------------------------------- images

IMAGE_PX = 128            # X2I resizes every input image to 128^2 first
VIDEO_FRAMES = 8
# the image path's encoder on the kernel route against the same encoder
# on the plain attention (ViT and LM), and the batch path's stacks
# against the serial encodes: max and mean |difference| relative to the
# reference's max and mean magnitude (_stack_errors); the ViT's features
# alone the same way. The kernel and the plain attention round p at other
# points, and the difference grows through 24 ViT and 24 LM layers, as
# the decode's does (ANSWER_REL_*).
IMAGE_REL_MAX, IMAGE_REL_MEAN = 6e-2, 3e-2


def media(family: str, seed: int, n: int, frames: int = 0):
    """n request images (or, with ``frames``, one video of that many
    frames) drawn from the seed at X2I's 128^2, and the route of the host
    half: PIL images where PIL is installed ("PIL": the encoder resizes,
    tiles and normalizes them), else the host half's output drawn from
    the seed at its exact shapes and dtypes ("arrays": InternVL's
    (1, 448, 448, 3) float32 tiles, Qwen2.5-VL's (flat patches,
    grid_thw) pairs, MiniCPM-o's (patches, (32, 32)) pairs of one 448^2
    slice an image or frame)."""
    import numpy as np
    rng = np.random.default_rng([seed, n, frames])
    count = frames or n
    pixels = [rng.integers(0, 256, (IMAGE_PX, IMAGE_PX, 3), np.uint8)
              for _ in range(count)]
    try:
        from PIL import Image
    except ImportError:
        if family == "minicpm":
            return [(rng.standard_normal((1024, 588)).astype(np.float32),
                     (32, 32)) for _ in range(count)], "arrays"
        if family == "internvl":
            return [rng.standard_normal((1, 448, 448, 3)).astype(np.float32)
                    for _ in range(n)], "arrays"
        # 112^2 (smart_resize of 128^2): 8 x 8 patches of 3 x 2 x 14^2
        t = max(1, -(-frames // 2))
        pairs = [(rng.standard_normal((t * 64, 1176)).astype(np.float32),
                  (t, 8, 8)) for _ in range(1 if frames else n)]
        return (pairs[0] if frames else pairs), "arrays"
    out = [Image.fromarray(a) for a in pixels]
    return out, "PIL"


def draw_internvl(name: str, lm, seed: int, tok):
    """The InternVL2.5 encoder of registry entry ``name`` over ``lm``: its
    InternViT-300M and mlp1 drawn on the card, ``<IMG_CONTEXT>`` the
    tokenizer's."""
    import dataclasses
    import zlib

    import torch
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.models.internvl import InternVLEncoder
    from x2i_torch.params import random_init_

    cfg = dataclasses.replace(
        MODEL_REGISTRY[name].internvl,
        img_context_token_id=tok.convert_tokens_to_ids("<IMG_CONTEXT>"))
    dev = lm.embed_tokens.weight.device
    g = torch.Generator(device=dev).manual_seed(
        seed + zlib.crc32(f"{name} vision".encode()))
    enc = InternVLEncoder(cfg, dev, language_model=lm)
    for part in (enc.vision_model, enc.mlp1_norm, enc.mlp1_fc1,
                 enc.mlp1_fc2):
        random_init_(part, g)
    return enc


def draw_qwen_tower(name: str, lm, seed: int, tok):
    """-> (the Qwen2.5-VL config of entry ``name`` with the tokenizer's
    vision token ids, its vision tower drawn on the card at the LM's
    width)."""
    import zlib

    import torch
    from x2i_torch.models.qwen2_5_vl import (Qwen2_5_VLConfig,
                                             QwenVisionConfig,
                                             QwenVisionTransformer)
    from x2i_torch.params import random_init_

    ids = tok.convert_tokens_to_ids
    cfg = Qwen2_5_VLConfig(
        vision=QwenVisionConfig(out_hidden_size=lm.cfg.hidden_size),
        llm=lm.cfg, image_token_id=ids("<|image_pad|>"),
        video_token_id=ids("<|video_pad|>"),
        vision_start_token_id=ids("<|vision_start|>"))
    dev = lm.embed_tokens.weight.device
    g = torch.Generator(device=dev).manual_seed(
        seed + zlib.crc32(f"{name} vision".encode()))
    return cfg, random_init_(QwenVisionTransformer(cfg.vision, dev), g)


def draw_minicpmo(name: str, lm, seed: int):
    """MiniCPM-o's encoder of registry entry ``name`` over ``lm``:
    SigLIP-so400m (26 blocks), the resampler, the Whisper-medium encoder
    and the audio projector drawn on the card."""
    import zlib

    import torch
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.models.minicpmo import MiniCPMOEncoder
    from x2i_torch.params import random_init_

    dev = lm.embed_tokens.weight.device
    g = torch.Generator(device=dev).manual_seed(
        seed + zlib.crc32(f"{name} vision".encode()))
    enc = MiniCPMOEncoder(MODEL_REGISTRY[name].minicpmo, dev,
                          language_model=lm)
    for part in (enc.vpm, enc.resampler, enc.apm, enc.audio_projector):
        random_init_(part, g)
    return enc


def set_attention_impl(module, impl: str):
    """Every block under ``module`` (ViT, LM) on attention ``impl``."""
    import dataclasses
    for m in module.modules():
        cfg = getattr(m, "cfg", None)
        if cfg is not None and hasattr(cfg, "attention_impl"):
            m.cfg = dataclasses.replace(cfg, attention_impl=impl)


def image_launches(quantized=False, lm_layers: int = 24,
                   vit_layers: int = 24, steps: int = 4, n2: int = 19,
                   n1: int = 38):
    """One image of an InternVL request with images: the text image's
    counts and one K1b (exact body) per ViT layer."""
    want = expected_launches(quantized, steps, n2, n1, lm_layers=lm_layers)
    want["flash_fwd"] += vit_layers
    return want


def _vit_ms(vision, images):
    """The host half's time for the request's images (PIL resize, tiles)
    and the card's for their ViT + mlp1 (``call_ms`` of
    ``extract_feature``)."""
    import numpy as np
    import torch
    from x2i_torch.data.vision import image_tiles
    t0 = time.perf_counter()
    tiles = np.concatenate([image_tiles(im) for im in images])
    host_ms = (time.perf_counter() - t0) * 1e3
    px = torch.as_tensor(tiles, device="cuda")
    with torch.inference_mode():
        vit_ms = call_ms(lambda: vision.extract_feature(px), iters=10)
    return {"host_half_ms": host_ms, "vit_ms": vit_ms,
            "tiles": int(tiles.shape[0])}


def check_image_routes(vision, encoder_fn, request, images):
    """The encoder's stack for ``request`` on the kernel route (K1 in every
    ViT and LM layer) against the same encoder on the plain attention,
    and the ViT's features alone the same way; the plain route launches
    no kernel."""
    import numpy as np
    import torch
    from x2i_torch.data.vision import image_tiles

    px = torch.as_tensor(np.concatenate([image_tiles(im) for im in images]),
                         device="cuda")
    with torch.inference_mode():
        got, feats = encoder_fn(request), vision.extract_feature(px)
        set_attention_impl(vision, "plain")
        try:
            reset_counts()
            want, want_feats = (encoder_fn(request),
                                vision.extract_feature(px))
            plain = launch_counts()
        finally:
            set_attention_impl(vision, "auto")
    rec = {"stack_err": _stack_errors(got, want),
           "layer_err": _layer_errors(got, want),
           "vit_feature_err": _stack_errors(feats, want_feats),
           "plain_route_launches": sum(plain.values())}
    ok = (all(e[0] <= IMAGE_REL_MAX and e[1] <= IMAGE_REL_MEAN
              for e in (rec["stack_err"], rec["vit_feature_err"]))
          and rec["plain_route_launches"] == 0
          and bool(torch.isfinite(got).all()))
    return rec, ok


def check_image_batch(pipe, vision, seed: int, images, route: str):
    """Two image requests through the batch path: one ViT call for both
    (counted by a hook), their stacks against the two serial encodes, and
    one ``run_batch`` of two 1024^2 images with exact launch counts (the
    ViT, the LM and the DiT at batch 2 launch as at batch 1)."""
    import torch
    reqs = [{"task": "image2image", "images": images[:1]},
            {"task": "imagetext2image", "prompt": PROMPTS[2],
             "images": images[1:]}]
    calls = []
    hook = vision.vision_model.register_forward_hook(
        lambda *a: calls.append(1))
    try:
        with torch.inference_mode():
            batched = pipe.encoder_fn.batch(reqs)
            batch_calls = len(calls)
            serial = torch.cat([pipe.encoder_fn(r) for r in reqs])
    finally:
        hook.remove()
    reset_counts()
    t0 = time.perf_counter()
    imgs = pipe.run_batch(reqs, seed=seed)
    sec = time.perf_counter() - t0
    counts = launch_counts()
    want = image_launches()
    rec = {"phase": "image-batch", "model": MODEL, "requests": len(reqs),
           "host_half": route, "vit_calls": batch_calls,
           "stack_err_vs_serial": _stack_errors(batched, serial),
           "image_shapes": list(imgs.shape), "seconds": sec,
           "launches": counts, "launches_expected": want}
    emit(rec)
    if not (batch_calls == 1 and counts == want
            and tuple(imgs.shape) == (2, 1024, 1024, 3)
            and all(float(i.std()) > 0 for i in imgs)
            and rec["stack_err_vs_serial"][0] <= IMAGE_REL_MAX
            and rec["stack_err_vs_serial"][1] <= IMAGE_REL_MEAN):
        raise AssertionError(f"the image batch path failed: {rec}")


def phase_image(pipe, lm, seed: int, card: str):
    """The image path of x2i-internvl2.5-1b at full width on the serving
    pipeline's LM, proj, DiT and VAE: InternViT-300M and mlp1 drawn on
    the card, the family's template through ``ByteTokenizer``; one
    image2image and one imagetext2image at 1024^2 (one 448 tile an image,
    256 ``<IMG_CONTEXT>`` tokens) with exact launch counts (K1b 24 in the
    ViT and 24 in the LM, K1a 228, K5 460), s/image, the ViT's ms and the
    peak memory; the encoder's stack on the kernel route against the
    plain attention (``check_image_routes``); two image requests through
    the batch path (``check_image_batch``). -> the launch counts of the
    image2image image."""
    import gc

    import torch
    from x2i_torch.convert.load import mllm_encoder
    from x2i_torch.pipeline import X2IPipeline

    tok = ByteTokenizer("internvl")
    t0 = time.perf_counter()
    vision = draw_internvl(MODEL, lm, seed, tok)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    encoder_fn = mllm_encoder(MODEL, lm, tok, vision.cfg, vision)
    entry = X2IPipeline(encoder_fn=encoder_fn, proj=pipe.proj,
                        flux=pipe.flux, vae=pipe.vae,
                        scheduler=pipe.scheduler, gen_cfg=pipe.gen_cfg,
                        encoder_batch_fn=encoder_fn.batch)
    images, route = media("internvl", seed, 2)
    want = image_launches()
    out = None
    for task, req in (("image2image", {"images": images[:1]}),
                      ("imagetext2image", {"prompt": PROMPTS[1],
                                           "images": images[1:]})):
        request = {"task": task, **req}
        rec, _, got = run_image(entry, seed, f"image[{task}]", want,
                                request=request)
        rec.update(host_half=route, vit_draw_s=draw_s,
                   vit_weight_bytes=_weight_bytes(vision.vision_model),
                   card=card, **_vit_ms(vision, req["images"]))
        routes, routes_ok = check_image_routes(vision, encoder_fn, request,
                                               req["images"])
        rec.update(routes)
        emit(rec)
        if got != want or not routes_ok:
            raise AssertionError(f"the image path failed: {rec}")
        out = out or got
    check_image_batch(entry, vision, seed, images, route)
    del entry, encoder_fn, vision
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------- checkpoints

# each family's special tokens, ids from 256 on in this order (the
# fixture tokenizers of tests/ckpt_fixtures.py have the same)
FAMILY_SPECIALS = {
    "qwenvl": ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
               "<|vision_start|>", "<|vision_end|>", "<|image_pad|>",
               "<|video_pad|>"),
    "internvl": ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<img>",
                 "</img>", "<IMG_CONTEXT>"),
    "minicpm": ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<image>",
                "</image>", "<audio>", "</audio>", "<unk>"),
}


def family_of(model: str) -> str:
    return next(f for f in FAMILY_SPECIALS if f in model)


def _byte_ids():
    """Byte -> id in the byte-level BPE vocabulary's order (GPT-2's
    ``bytes_to_unicode``: the printable bytes first, then the others)."""
    first = [*range(33, 127), *range(161, 173), *range(174, 256)]
    order = first + [b for b in range(256) if b not in first]
    return {b: i for i, b in enumerate(order)}


class ByteTokenizer:
    """The tokenizer this script hands the encoders (the machine with the
    card has no ``transformers``): each UTF-8 byte is one id (a byte-level
    BPE without merges), the family's special tokens follow at 256 on,
    ``apply_chat_template`` renders ChatML (a history's assistant turns
    too), a call pads each text on the right to ``max_length`` with
    ``<|endoftext|>``, and ``decode`` maps ids back to text: the ids and
    texts of the HF tokenizers of the test fixtures
    (tests/ckpt_fixtures.py), which tests/test_torch_checkpoint_dirs.py
    holds it to. ``eos_token_id`` is Qwen2.5-VL's released
    ``<|im_end|>`` id 151645 for qwenvl (the JAX encoder's default, in
    the 7B LM's vocabulary), the family's own ``<|im_end|>`` otherwise."""

    def __init__(self, family: str):
        import re
        self.byte_id = _byte_ids()
        self.special = {t: 256 + i
                        for i, t in enumerate(FAMILY_SPECIALS[family])}
        self._split = re.compile("(" + "|".join(
            re.escape(t) for t in self.special) + ")")
        self.pad_token_id = self.special["<|endoftext|>"]
        self.eos_token_id = (151645 if family == "qwenvl"
                             else self.special["<|im_end|>"])
        self._byte = {i: b for b, i in self.byte_id.items()}
        self._token = {i: t for t, i in self.special.items()}

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.special[token]

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """Text of ``ids``: byte runs decoded as UTF-8 (errors replaced),
        special tokens as their text unless skipped; ids outside the
        vocabulary (a random LM's answer) give nothing."""
        out, run = [], bytearray()
        for i in (int(i) for i in ids):
            if i in self._byte:
                run.append(self._byte[i])
                continue
            out.append(run.decode(errors="replace"))
            run = bytearray()
            if i in self._token and not skip_special_tokens:
                out.append(self._token[i])
        return "".join(out) + run.decode(errors="replace")

    def encode(self, text: str):
        ids = []
        for part in self._split.split(text):
            ids.extend([self.special[part]] if part in self.special
                       else [self.byte_id[b] for b in part.encode()])
        return ids

    @staticmethod
    def apply_chat_template(messages, tokenize=False,
                            add_generation_prompt=True):
        assert not tokenize
        out = ""
        for m in messages:
            content = m["content"]
            if not isinstance(content, str):
                content = "".join(
                    {"image": "<|vision_start|><|image_pad|><|vision_end|>",
                     "video": "<|vision_start|><|video_pad|><|vision_end|>"
                     }.get(item["type"], item.get("text", ""))
                    for item in content)
            out += f"<|im_start|>{m['role']}\n{content}<|im_end|>\n"
        return out + ("<|im_start|>assistant\n" if add_generation_prompt
                      else "")

    def __call__(self, texts, padding="max_length", max_length=512,
                 truncation=True):
        assert padding == "max_length" and truncation
        single = isinstance(texts, str)
        rows = [self.encode(t)[:max_length]
                for t in ([texts] if single else texts)]
        ids = [r + [self.pad_token_id] * (max_length - len(r)) for r in rows]
        mask = [[1] * len(r) + [0] * (max_length - len(r)) for r in rows]
        if single:
            return {"input_ids": ids[0], "attention_mask": mask[0]}
        return {"input_ids": ids, "attention_mask": mask}


class EndTokenizer(ByteTokenizer):
    """The teachers' tokenizers of this script (the machine with the card
    has no ``transformers``): the text's byte ids, cut to leave room for
    ``end`` and followed by it, padded on the right with ``pad`` to
    ``max_length``; the mask marks the text and ``end``. CLIP's layout
    (``end`` = ``pad`` = its <|endoftext|>, 77 ids: the pooled row is the
    end token's) and T5's (``</s>`` = 1 after the text, ``<pad>`` = 0)."""

    def __init__(self, end: int, pad: int):
        super().__init__("qwenvl")
        self.end, self.pad = end, pad

    def __call__(self, texts, padding="max_length", max_length=77,
                 truncation=True):
        assert padding == "max_length" and truncation
        single = isinstance(texts, str)
        rows = [self.encode(t)[:max_length - 1] + [self.end]
                for t in ([texts] if single else texts)]
        ids = [r + [self.pad] * (max_length - len(r)) for r in rows]
        mask = [[1] * len(r) + [0] * (max_length - len(r)) for r in rows]
        if single:
            return {"input_ids": ids[0], "attention_mask": mask[0]}
        return {"input_ids": ids, "attention_mask": mask}


# safetensors' names of the torch dtypes this script writes
ST_DTYPES = {"torch.bfloat16": "BF16", "torch.float32": "F32"}


def write_safetensors(path: str, entries):
    """Write a safetensors file from ``entries`` [(name, shape, torch
    dtype, make)], ``make()`` giving the tensor: the header first (from
    the shapes), then each tensor's bytes in turn, so that the host holds
    one tensor at a time. -> bytes written."""
    import torch
    header, off = {}, 0
    for name, shape, dtype, _ in entries:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": ST_DTYPES[str(dtype)], "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for name, shape, dtype, make in entries:
            t = make().to(dtype).contiguous().cpu()
            assert tuple(t.shape) == tuple(shape), name
            f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(head) + off


def _drawn(g, shape, name):
    """A checkpoint tensor drawn on the card: matrices and convolutions at
    std 1/sqrt(fan_in), embeddings (the token table, InternViT's CLS and
    position table) at std 1, biases at 0.02, norm, channel and residual
    scales 1 + N(0, 0.05^2)."""
    import torch

    def make():
        x = torch.randn(shape, generator=g, device="cuda")
        if "embed_tokens" in name or name.endswith("embedding"):
            return x
        if len(shape) >= 2 and "cha_scale" not in name:
            return x / math.sqrt(math.prod(shape[1:]))
        if name.endswith("bias"):
            return 0.02 * x
        return 1.0 + 0.05 * x
    return make


def _entries(module_cls, cfg, plan, g, prefix="", released=None):
    """(name, shape, bf16, make) of every checkpoint key of ``plan``, the
    shapes those of the port module it fills (torch layouts are the
    checkpoint's): the checkpoint side of the port's own converter, whose
    key names the CPU tests hold against the JAX converters. A key that
    fills several parameters (a packed projection) stacks their rows;
    ``released``: {key: shape} where the checkpoint's shape is not the
    module's (a patch convolution the module keeps flattened)."""
    import torch
    meta = module_cls(cfg, device="meta")
    shapes = {**{n: p.shape for n, p in meta.named_parameters()},
              **{n: b.shape for n, b in meta.named_buffers()}}
    out = []
    for key, dst in plan.items():
        dsts = dst if isinstance(dst, list) else [dst]
        first = tuple(shapes[dsts[0][0]])
        shape = (released or {}).get(
            key, (len(dsts) * first[0], *first[1:]))
        out.append((prefix + key, shape, torch.bfloat16,
                    _drawn(g, shape, key)))
    return out


CKPT_MODEL = "x2i-internvl2.5-1b"
CKPT_BLOCKS = (1, 2)                      # double, single


def write_checkpoint_dirs(root: str, seed: int):
    """A released-layout checkpoint set of x2i-internvl2.5-1b at full width,
    the DiT cut to 1 double + 2 single blocks, weights drawn on the card:
    a diffusers FLUX directory (the transformer in two shards, the whole
    VAE, the scheduler's config), an InternVL directory (InternViT-300M
    under ``vision_model.``, mlp1, the Qwen2.5-0.5B LM under
    ``language_model.``, config.json with ``llm_config`` and
    ``vision_config``) and the proj's .bin with DDP ``module.`` prefixes.
    -> (flux, mllm, proj paths, bytes written)."""
    import dataclasses
    import os

    import torch
    from x2i_torch.convert.torch_models import (flux_plan, internvl_plan,
                                                proj_plan, vae_plan)
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.models.internvl import InternVLEncoder
    from x2i_torch.models.proj import Proj
    from x2i_torch.models.vae import AutoencoderKL

    spec = MODEL_REGISTRY[CKPT_MODEL]
    g = torch.Generator(device="cuda").manual_seed(seed)
    flux_cfg = dataclasses.replace(spec.flux, num_layers=CKPT_BLOCKS[0],
                                   num_single_layers=CKPT_BLOCKS[1])
    flux, mllm = os.path.join(root, "flux"), os.path.join(root, "internvl")
    for d in ("transformer", "vae", "scheduler"):
        os.makedirs(os.path.join(flux, d))
    os.makedirs(mllm)
    written = 0
    dit = _entries(FluxTransformer2D, flux_cfg, flux_plan(flux_cfg), g)
    half = len(dit) // 2
    for i, part in enumerate((dit[:half], dit[half:])):
        written += write_safetensors(os.path.join(
            flux, "transformer",
            f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"),
            part)
    c = flux_cfg
    _write_json(os.path.join(flux, "transformer", "config.json"), {
        "_class_name": "FluxTransformer2DModel", "patch_size": c.patch_size,
        "in_channels": c.in_channels, "num_layers": c.num_layers,
        "num_single_layers": c.num_single_layers,
        "attention_head_dim": c.attention_head_dim,
        "num_attention_heads": c.num_attention_heads,
        "joint_attention_dim": c.joint_attention_dim,
        "pooled_projection_dim": c.pooled_projection_dim,
        "guidance_embeds": c.guidance_embeds,
        "axes_dims_rope": list(c.axes_dims_rope)})
    v = spec.vae
    written += write_safetensors(
        os.path.join(flux, "vae", "diffusion_pytorch_model.safetensors"),
        _entries(AutoencoderKL, v, vae_plan(v), g))
    _write_json(os.path.join(flux, "vae", "config.json"), {
        "_class_name": "AutoencoderKL", "in_channels": 3,
        "out_channels": v.out_channels, "latent_channels": v.latent_channels,
        "block_out_channels": list(v.block_out_channels),
        "layers_per_block": v.layers_per_block,
        "norm_num_groups": v.norm_num_groups,
        "scaling_factor": v.scaling_factor, "shift_factor": v.shift_factor,
        "mid_block_add_attention": v.use_mid_attention})
    _write_json(os.path.join(flux, "scheduler", "scheduler_config.json"), {
        "_class_name": "FlowMatchEulerDiscreteScheduler",
        "num_train_timesteps": 1000, "shift": 1.0,
        "use_dynamic_shifting": False})
    llm, vit = spec.llm, spec.internvl.vision
    written += write_safetensors(
        os.path.join(mllm, "model.safetensors"),
        _entries(InternVLEncoder, spec.internvl,
                 internvl_plan(spec.internvl), g))
    _write_json(os.path.join(mllm, "config.json"), {
        "model_type": "internvl_chat", "downsample_ratio": 0.5,
        "ps_version": "v2", "force_image_size": vit.image_size,
        "llm_config": {"architectures": ["Qwen2ForCausalLM"],
                       "vocab_size": llm.vocab_size,
                       "hidden_size": llm.hidden_size,
                       "intermediate_size": llm.intermediate_size,
                       "num_hidden_layers": llm.num_hidden_layers,
                       "num_attention_heads": llm.num_attention_heads,
                       "num_key_value_heads": llm.num_key_value_heads,
                       "rope_theta": llm.rope_theta,
                       "rms_norm_eps": llm.rms_norm_eps,
                       "max_position_embeddings":
                           llm.max_position_embeddings,
                       "tie_word_embeddings": True},
        "vision_config": {
            "hidden_size": vit.hidden_size,
            "intermediate_size": vit.intermediate_size,
            "num_hidden_layers": vit.num_hidden_layers,
            "num_attention_heads": vit.num_attention_heads,
            "image_size": vit.image_size, "patch_size": vit.patch_size,
            "qkv_bias": vit.qkv_bias,
            "qk_normalization": vit.qk_normalization,
            "norm_type": "layer_norm"}})
    proj = os.path.join(root, "diffusion_pytorch_model.bin")
    sd = {"module." + name: make().to(dtype).cpu()
          for name, _, dtype, make in _entries(
              Proj, spec.proj, proj_plan(spec.proj), g)}
    torch.save(sd, proj)
    written += os.path.getsize(proj)
    return flux, mllm, proj, written


CKPT_MINICPM_LAYERS = 2                    # the LM's depth in the fixture


def write_minicpm_dir(root: str, seed: int):
    """A MiniCPM-o-2.6 directory in the released layout, weights drawn on
    the card: SigLIP-so400m (all 27 blocks, as released; MiniCPM runs 26),
    the resampler (its in-projection packed), the Whisper-medium encoder
    (with the stored position table it does not read) and the audio
    projector at full width, the Qwen2-7B LM cut to 2 full-width layers,
    one ``tts.`` tensor; the flat config.json with ``vision_config``,
    ``audio_config`` and ``query_num``; and a proj .bin over the cut LM's
    3 hidden states. -> (mllm path, proj path, the cut config, bytes
    written)."""
    import dataclasses
    import os

    import torch
    from x2i_torch.convert.torch_models import minicpmo_plan, proj_plan
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.models.minicpmo import MiniCPMOEncoder
    from x2i_torch.models.proj import Proj

    spec = MODEL_REGISTRY[MINICPM_MODEL]
    cfg = dataclasses.replace(spec.minicpmo, llm=dataclasses.replace(
        spec.llm, num_hidden_layers=CKPT_MINICPM_LAYERS))
    v, a, llm = cfg.vision, cfg.audio, cfg.llm
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    path = os.path.join(root, "minicpm")
    os.makedirs(path)
    patch = "vpm.embeddings.patch_embedding.weight"
    entries = _entries(MiniCPMOEncoder, cfg, minicpmo_plan(cfg), g,
                       released={patch: (v.hidden_size, 3, v.patch_size,
                                         v.patch_size)})
    last = v.effective_layers
    entries += [(k.replace(".0.", f".{last}.", 1), shape, dt,
                 _drawn(g, shape, k)) for k, shape, dt, _ in entries
                if k.startswith("vpm.encoder.layers.0.")]
    entries += [("apm.embed_positions.weight",
                 (a.max_source_positions, a.d_model), torch.bfloat16,
                 _drawn(g, (a.max_source_positions, a.d_model), "pos")),
                ("tts.emb_text.weight", (4, 768), torch.bfloat16,
                 _drawn(g, (4, 768), "tts"))]
    written = write_safetensors(os.path.join(path, "model.safetensors"),
                                entries)
    _write_json(os.path.join(path, "config.json"), {
        "model_type": "minicpmo", "vocab_size": llm.vocab_size,
        "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size,
        "num_hidden_layers": llm.num_hidden_layers,
        "num_attention_heads": llm.num_attention_heads,
        "num_key_value_heads": llm.num_key_value_heads,
        "rope_theta": llm.rope_theta, "rms_norm_eps": llm.rms_norm_eps,
        "tie_word_embeddings": llm.tie_word_embeddings,
        "query_num": cfg.query_num, "audio_pool_step": cfg.audio_pool_step,
        "vision_config": {f: getattr(v, f) for f in (
            "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "image_size", "patch_size")},
        "audio_config": {f: getattr(a, f) for f in (
            "num_mel_bins", "d_model", "encoder_layers",
            "encoder_attention_heads", "encoder_ffn_dim",
            "max_source_positions")}})
    proj_cfg = dataclasses.replace(spec.proj,
                                   in_channels=CKPT_MINICPM_LAYERS + 1)
    proj = os.path.join(root, "minicpm_proj.bin")
    torch.save({"module." + name: make().to(dtype).cpu()
                for name, _, dtype, make in _entries(
                    Proj, proj_cfg, proj_plan(proj_cfg), g)}, proj)
    return path, proj, cfg, written + os.path.getsize(proj)


def checkpoint_minicpm(root: str, flux: str, seed: int):
    """MiniCPM-o's checkpoint into the port: ``write_minicpm_dir``'s
    directory loaded by ``build_pipeline_from_checkpoints`` onto the card
    (bf16) beside the phase's cut DiT, and onto the CPU; every tensor of
    the card's encoder (SigLIP, the resampler, Whisper, the projector,
    the LM) and proj bit for bit the CPU copy; unread only the ``tts.``
    tensor, SigLIP's 27th block and Whisper's stored position table; one
    1024^2 x2image (prompt, image, 5 s of audio) with exact launch counts
    (K1b: 2 LM layers and the resampler). -> (its launch counts, the
    MiniCPM-o directory, its proj's .bin)."""
    import gc

    import torch
    from x2i_torch.convert.load import build_pipeline_from_checkpoints

    t0 = time.perf_counter()
    mllm, proj, cfg, written = write_minicpm_dir(root, seed)
    write_s = time.perf_counter() - t0
    tok = ByteTokenizer("minicpm")
    args = (MINICPM_MODEL, flux, mllm, proj)
    t0 = time.perf_counter()
    pipe = build_pipeline_from_checkpoints(*args, tokenizer=tok,
                                           quantized=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ref = build_pipeline_from_checkpoints(*args, tokenizer=tok,
                                          quantized=False, device="cpu")
    mismatched, compared = [], 0
    pairs = [(pipe.encoder_fn.ctx["vision"], ref.encoder_fn.ctx["vision"],
              "mllm"), (pipe.proj, ref.proj, "proj")]
    for card_mod, cpu_mod, name in pairs:
        card = card_mod.state_dict()
        for k, val in cpu_mod.state_dict().items():
            compared += 1
            if not torch.equal(card[k].cpu(), val):
                mismatched.append(f"{name}.{k}")
    del ref
    gc.collect()
    unread = pipe.load_report["mllm"]["unread"]
    last = cfg.vision.effective_layers
    want_unread = sorted(
        ["tts.emb_text.weight", "apm.embed_positions.weight"]
        + [k for k in unread if k.startswith(f"vpm.encoder.layers.{last}.")])
    rec = {"phase": "checkpoint-minicpm-load", "model": MINICPM_MODEL,
           "lm_layers": CKPT_MINICPM_LAYERS,
           "cut": "LM cut to 2 of 28 full-width layers; encoders whole",
           "bytes_written": written, "write_s": write_s, "load_s": load_s,
           "bytes_read": pipe.load_report["mllm"]["bytes"],
           "tensors_compared": compared, "mismatched": mismatched,
           "unread": unread}
    emit(rec)
    if (mismatched or unread != want_unread
            or sum(k.startswith("vpm.") for k in unread) != 16):
        raise AssertionError(f"the MiniCPM-o checkpoint load is wrong: "
                             f"{rec}")
    n2, n1 = CKPT_BLOCKS
    want = expected_launches(False, 4, n2=n2, n1=n1,
                             lm_layers=CKPT_MINICPM_LAYERS)
    want["flash_fwd"] += 1                              # the resampler
    images, route = media("minicpm", seed, 1)
    request = {"task": "x2image", "prompt": PROMPTS[1], "images": images,
               "audio": clip(seed, AUDIO_SECONDS)}
    img_rec, _, counts = run_image(pipe, seed, "checkpoint-minicpm-image",
                                   want, model=MINICPM_MODEL,
                                   request=request)
    img_rec["host_half"] = route
    emit(img_rec)
    if counts != want:
        raise AssertionError(f"the loaded MiniCPM-o pipeline missed its "
                             f"kernels: {counts} != {want}")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return counts, mllm, proj


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _host_peak_bytes() -> int:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _host_rss_bytes() -> int:
    import os
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


VAE_ENCODE_PX = 128             # the CPU's bf16 encoder at 1024^2 takes minutes


def check_vae_encode(card_vae, cpu_vae, seed: int):
    """The loaded VAE's encode on the card against the CPU copy's, both
    bf16, on a VAE_ENCODE_PX^2 image drawn from the seed: the mode, and a
    sample on one noise drawn on the CPU. cuDNN and the CPU's convolutions
    sum in other orders, so both are held to an f32 encode of the same
    weights on the CPU: the card's relative L2 distance from it at most
    twice the CPU bf16 copy's, and its correlation with the CPU copy's
    above 0.999."""
    import dataclasses

    import torch
    from x2i_torch.models.vae import AutoencoderKL

    exact = AutoencoderKL(dataclasses.replace(cpu_vae.cfg,
                                              dtype=torch.float32))
    exact.load_state_dict(cpu_vae.state_dict())
    g = torch.Generator().manual_seed(seed)
    px = torch.rand((1, VAE_ENCODE_PX, VAE_ENCODE_PX, 3), generator=g) * 2 - 1
    side = VAE_ENCODE_PX // 8
    eps = torch.randn((1, side, side, card_vae.cfg.latent_channels),
                      generator=g)
    out = {}
    with torch.inference_mode():
        for name, e in (("mode", None), ("sample", eps)):
            got = card_vae.encode(px.cuda(), e).float().cpu().flatten()
            want = cpu_vae.encode(px, e).float().flatten()
            ref = exact.encode(px, e).flatten()
            out[name] = {
                "rel_l2_vs_f32": ((got - ref).norm() / ref.norm()).item(),
                "cpu_bf16_rel_l2_vs_f32": ((want - ref).norm()
                                           / ref.norm()).item(),
                "rel_l2_vs_cpu": ((got - want).norm() / want.norm()).item(),
                "corr_vs_cpu": torch.corrcoef(torch.stack([got, want]))[0, 1]
                .item(), "finite": bool(torch.isfinite(got).all())}
    out["ok"] = all(r["finite"] and r["corr_vs_cpu"] > 0.999
                    and r["rel_l2_vs_f32"] <= 2 * r["cpu_bf16_rel_l2_vs_f32"]
                    for r in out.values())
    return out


def phase_checkpoint(seed: int, smi: str):
    """Checkpoints into the port, first of the model phases (the host's
    peak memory is then the load's own): write the released-layout set of
    ``write_checkpoint_dirs`` to a temporary directory; load it with
    ``build_pipeline_from_checkpoints`` onto the card (bf16), time it and
    read the host's and the card's peak memory; load it again on the CPU
    (loading only) and hold every parameter and buffer of the card's copy
    to it bit for bit (the CPU route is the one the CPU tests hold against
    JAX), the whole InternVL encoder and the VAE's encoder among them
    (nothing of the directory unread), and the VAE's encode on the card
    against the CPU copy's (``check_vae_encode``); make one 1024^2 4-step
    imagetext2image with exact launch counts (fused glue, as served; K1b
    in the 24 ViT and 24 LM layers); load it again in the default w8 and
    make the same image, held to the bf16 image by the route bar of the
    quantized checks (correlation above 0.999, relative L2 below 5e-2)."""
    import gc
    import shutil
    import tempfile

    import torch
    from x2i_torch.convert.load import build_pipeline_from_checkpoints

    root = tempfile.mkdtemp(prefix="x2i_ckpt_")
    try:
        t0 = time.perf_counter()
        flux, mllm, proj, written = write_checkpoint_dirs(root, seed)
        write_s = time.perf_counter() - t0
        tok = ByteTokenizer("internvl")
        args = (CKPT_MODEL, flux, mllm, proj)
        gc.collect()
        rss0, peak0 = _host_rss_bytes(), _host_peak_bytes()
        torch.cuda.reset_peak_memory_stats()
        dev0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pipe = build_pipeline_from_checkpoints(*args, tokenizer=tok,
                                               quantized=False)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak1 = _host_peak_bytes()
        rep = pipe.load_report
        read = sum(r["bytes"] for r in rep.values())
        rec = {"phase": "checkpoint-load", "model": CKPT_MODEL,
               "blocks": list(CKPT_BLOCKS), "bytes_written": written,
               "write_s": write_s, "load_s": load_s, "bytes_read": read,
               "gb_per_s": read / load_s / 1e9,
               "tensors": {k: r["tensors"] for k, r in rep.items()},
               "unread": {k: len(r["unread"]) for k, r in rep.items()},
               # peak1 - rss0 bounds the load's own growth from above (an
               # earlier peak above rss0 counts in it too)
               "host_rss_before": rss0, "host_peak_before": peak0,
               "host_peak_after": peak1, "host_growth_bound": peak1 - rss0,
               "device_peak": torch.cuda.max_memory_allocated() - dev0}
        t0 = time.perf_counter()
        ref = build_pipeline_from_checkpoints(*args, tokenizer=tok,
                                              quantized=False, device="cpu")
        rec["cpu_load_s"] = time.perf_counter() - t0
        mismatched, compared = [], 0
        for name in ("flux", "vae", "proj"):
            card = getattr(pipe, name).state_dict()
            for k, v in getattr(ref, name).state_dict().items():
                compared += 1
                if not torch.equal(card[k].cpu(), v):
                    mismatched.append(f"{name}.{k}")
        # the whole encoder: InternViT, mlp1 and the LM
        card = pipe.encoder_fn.ctx["vision"].state_dict()
        for k, v in ref.encoder_fn.ctx["vision"].state_dict().items():
            compared += 1
            if not torch.equal(card[k].cpu(), v):
                mismatched.append(f"mllm.{k}")
        rec.update(tensors_compared=compared, mismatched=mismatched,
                   vae_encode=check_vae_encode(pipe.vae, ref.vae, seed))
        del ref
        gc.collect()
        emit(rec)
        unread = {k: r["unread"] for k, r in rep.items()}
        if (mismatched or any(unread.values())
                or rec["host_growth_bound"] > written / 4
                or not rec["vae_encode"]["ok"]):
            raise AssertionError(f"the checkpoint load is wrong: {rec}")

        n2, n1 = CKPT_BLOCKS
        want = image_launches(n2=n2, n1=n1)
        images, route = media("internvl", seed, 1)
        request = {"task": "imagetext2image", "prompt": PROMPTS[1],
                   "images": images}
        img_rec, bf16_pixels, counts = run_image(
            pipe, seed, "checkpoint-image", want, model=CKPT_MODEL,
            request=request)
        img_rec["host_half"] = route
        emit(img_rec)
        if counts != want:
            raise AssertionError(f"the loaded pipeline missed its kernels: "
                                 f"{counts} != {want}")
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipe = build_pipeline_from_checkpoints(*args, tokenizer=tok)
        torch.cuda.synchronize()
        w8_load_s = time.perf_counter() - t0
        want = image_launches("w8", n2=n2, n1=n1)
        w8_rec, pixels, counts = run_image(pipe, seed, "checkpoint-image-w8",
                                           want, model=CKPT_MODEL,
                                           request=request)
        got, ref_px = pixels.float().flatten(), bf16_pixels.float().flatten()
        w8_rec.update(
            load_s=w8_load_s,
            rel_l2_vs_bf16=((got - ref_px).norm() / ref_px.norm()).item(),
            corr_vs_bf16=torch.corrcoef(torch.stack([got, ref_px]))[0, 1]
            .item())
        emit(w8_rec)
        if not (counts == want and pipe.flux.cfg.quantized == "w8"
                and w8_rec["corr_vs_bf16"] > 0.999
                and w8_rec["rel_l2_vs_bf16"] < 5e-2):
            raise AssertionError(f"the w8 load's image is wrong: {w8_rec}")
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        runs = {"checkpoint": img_rec["launches"],
                "checkpoint-w8": w8_rec["launches"]}
        runs["checkpoint-minicpm"], mc_mllm, mc_proj = checkpoint_minicpm(
            root, flux, seed)
        runs.update(phase_cli(root, flux, mllm, proj, mc_mllm, mc_proj,
                              seed, smi))
        runs["assemble"] = phase_assemble(root, flux, mllm, proj, seed, smi)
        return runs
    finally:
        shutil.rmtree(root)


# ------------------------------------------------------- entry points

CLI_LANGUAGE = "DE"            # the text2image bank's prompt of the phase
CLI_TOKENS = 8                 # answer tokens a chat turn


@contextlib.contextmanager
def byte_tokenizers():
    """The command-line phase's one seam: ``convert.load.mllm_tokenizer``
    (which imports transformers, absent on the card's machine) gives the
    ``ByteTokenizer`` of the model's family while the block runs."""
    from x2i_torch.convert import load as L
    real = L.mllm_tokenizer
    L.mllm_tokenizer = lambda model, path: ByteTokenizer(family_of(model))
    try:
        yield
    finally:
        L.mllm_tokenizer = real


def write_wav(path: str, seed: int):
    """``clip(seed, AUDIO_SECONDS)`` as 16-bit mono PCM at 16 kHz, through
    the stdlib ``wave``."""
    import wave

    import numpy as np
    pcm = np.clip(np.round(clip(seed, AUDIO_SECONDS) * 32767), -32768,
                  32767)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())


def run_cli(argv, module: str = "cli"):
    """``x2i_torch.cli.main(argv)`` (or ``convert.cli``'s) in this
    process, every count set to 0 just before it -> (its exit code, its
    seconds, the launch counts just after)."""
    import importlib

    import torch
    main = importlib.import_module(f"x2i_torch.{module}").main
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0, launch_counts()


def _free():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _states_equal(state, module) -> list:
    """The keys of ``state`` (CPU tensors) that are not bit for bit
    ``module``'s state dict entry, and those either side lacks."""
    import torch
    want = module.state_dict()
    bad = sorted(set(state) ^ set(want))
    return bad + [k for k in state if k in want and not (
        state[k].dtype == want[k].dtype
        and torch.equal(state[k], want[k].cpu()))]


def phase_cli(root: str, flux: str, mllm: str, proj: str, mc_mllm: str,
              mc_proj: str, seed: int, card: str):
    """The port's entry points, on the checkpoint phase's full-width
    x2i-internvl2.5-1b set (DiT cut to CKPT_BLOCKS) and its MiniCPM-o set,
    each in this process with ``byte_tokenizers`` as the one seam:

    * ``python -m x2i_torch.cli`` text2image at 1024^2 of the text2image
      bank's CLI_LANGUAGE prompt in the default w8 and in ``--quantize
      w8a8``, exact launch counts for the cut DiT with its fused glue; the
      w8 PNG's bytes equal those of ``png_bytes`` over the image that
      ``build_pipeline_from_checkpoints(...).run_task`` makes in this
      process at the same seed;
    * audio2image on the MiniCPM-o set from a 5 s 16 kHz WAV written by
      ``wave``;
    * ``multiturn``: two turns, then ``stop``, fed to ``input``:
      CLI_TOKENS answer tokens and one PNG a turn;
    * ``python -m x2i_torch.convert.cli`` flux ``--quantize w8a8``, vae,
      mllm and proj: each ``load_native`` state bit for bit the module
      ``build_pipeline_from_checkpoints(quantized="w8a8")`` builds, each
      conversion's seconds;
    * the ComfyUI nodes: ``MLLMLoader``, ``ProjLoader`` on the npz that
      ``save_proj_checkpoint`` writes from that pipeline's proj, and
      ``MLLMEncode``: the conditioning bit for bit ``pipe.encode``, with
      24 K1b launches.

    -> the launch counts of the runs, by name."""
    import builtins
    import os

    import numpy as np
    import torch
    from x2i_torch.cli import png_bytes
    from x2i_torch.convert.cli import load_native
    from x2i_torch.convert.load import build_pipeline_from_checkpoints
    from x2i_torch.integrations import comfyui
    from x2i_torch.prompts import TEXT2IMAGE_MULTILINGUAL

    n2, n1 = CKPT_BLOCKS
    prompt = TEXT2IMAGE_MULTILINGUAL[CLI_LANGUAGE]
    paths = (CKPT_MODEL, flux, mllm, proj)
    ckpt = ["--model", CKPT_MODEL, "--flux_path", flux, "--mllm_path", mllm,
            "--proj_path", proj, "--seed", str(seed)]
    out = os.path.join(root, "cli")
    os.makedirs(out)
    runs, recs, failed = {}, [], []

    def check(name, ok, rec):
        rec["ok"] = bool(ok)
        recs.append(rec)
        emit(rec)
        if not ok:
            failed.append(name)

    with byte_tokenizers():
        for mode in ("w8", "w8a8"):
            png = os.path.join(out, f"t2i-{mode}.png")
            rc, sec, counts = run_cli(["--task", "text2image", "--prompt",
                                       prompt, "--quantize", mode,
                                       "--output", png, *ckpt])
            want = expected_launches(mode, 4, n2=n2, n1=n1)
            runs[f"cli-{mode}"] = counts
            check(f"cli-{mode}", rc == 0 and counts == want, {
                "phase": f"cli-text2image-{mode}", "rc": rc, "seconds": sec,
                "png_bytes": os.path.getsize(png), "launches": counts,
                "launches_expected": want, "card": card})
        pipe = build_pipeline_from_checkpoints(
            *paths, seed=seed, tokenizer=ByteTokenizer("internvl"))
        img = pipe.run_task("text2image", prompt=prompt, seed=seed)
        with open(os.path.join(out, "t2i-w8.png"), "rb") as f:
            same = f.read() == png_bytes(img[0])
        check("cli-png", same and img.shape == (1, 1024, 1024, 3), {
            "phase": "cli-png", "png_equals_run_task": same,
            "image_std": float(img.std())})
        del pipe, img
        _free()

        wav, png = os.path.join(out, "a.wav"), os.path.join(out, "a2i.png")
        write_wav(wav, seed)
        rc, sec, counts = run_cli([
            "--task", "audio2image", "--audio", wav, "--output", png,
            "--model", MINICPM_MODEL, "--flux_path", flux, "--mllm_path",
            mc_mllm, "--proj_path", mc_proj, "--seed", str(seed)])
        want = expected_launches("w8", 4, n2=n2, n1=n1,
                                 lm_layers=CKPT_MINICPM_LAYERS)
        runs["cli-audio2image"] = counts
        check("cli-audio2image", rc == 0 and counts == want, {
            "phase": "cli-audio2image", "rc": rc, "seconds": sec,
            "audio_s": AUDIO_SECONDS, "launches": counts,
            "launches_expected": want})
        _free()

        lines = iter([PROMPTS[0], "now the same scene at night", "stop"])
        real_input = builtins.input
        builtins.input = lambda _="": next(lines)
        prefix = os.path.join(out, "mt_")
        try:
            rc, sec, counts = run_cli(["multiturn", *ckpt, "--max_new_tokens",
                                       str(CLI_TOKENS), "--output_prefix",
                                       prefix])
        finally:
            builtins.input = real_input
        want = {k: 2 * v for k, v in expected_launches(
            "w8", 4, n2=n2, n1=n1, lm_layers=0).items()}
        pngs = sorted(f for f in os.listdir(out) if f.startswith("mt_"))
        runs["cli-multiturn"] = counts
        check("cli-multiturn", rc == 0 and counts == want
              and pngs == ["mt_1.png", "mt_2.png"], {
                  "phase": "cli-multiturn", "rc": rc, "seconds": sec,
                  "turns": 2, "tokens_a_turn": CLI_TOKENS, "pngs": pngs,
                  "launches": counts, "launches_expected": want})
        _free()

        conversions = (("flux", flux, ["--quantize", "w8a8"]),
                       ("vae", flux, []), ("mllm", mllm, []),
                       ("proj", proj, []))
        native = {}
        for kind, src, extra in conversions:
            dst = os.path.join(out, f"native-{kind}")
            rc, sec, _ = run_cli([kind, "--src", src, "--dst", dst,
                                  "--model", CKPT_MODEL, *extra],
                                 "convert.cli")
            native[kind] = (rc, sec, dst)
        pipe = build_pipeline_from_checkpoints(
            *paths, quantized="w8a8", tokenizer=ByteTokenizer("internvl"))
        modules = {"flux": pipe.flux, "vae": pipe.vae,
                   "mllm": pipe.encoder_fn.ctx["vision"], "proj": pipe.proj}
        for kind, (rc, sec, dst) in native.items():
            state = load_native(dst)
            bad = _states_equal(state, modules[kind])
            check(f"convert-{kind}", rc == 0 and not bad, {
                "phase": f"cli-convert-{kind}", "rc": rc, "seconds": sec,
                "tensors": len(state), "bytes": sum(
                    t.numel() * t.element_size() for t in state.values()),
                "mismatched": bad[:8]})
            del state

        npz = os.path.join(out, "proj.npz")
        comfyui.save_proj_checkpoint(
            npz, comfyui.proj_config_dict(pipe.proj.cfg), pipe.proj)
        t0 = time.perf_counter()
        (encoder,) = comfyui.MLLMLoader().load("internvl2.5", mllm)
        (node_proj,) = comfyui.ProjLoader().load(npz)
        load_s = time.perf_counter() - t0
        reset_counts()
        ((embeds, extras),), = comfyui.MLLMEncode().encode(encoder, node_proj,
                                                          prompt)
        counts = launch_counts()
        pooled, want_embeds = pipe.encode({"task": "text2image",
                                           "prompt": prompt})
        same = (torch.equal(embeds, want_embeds)
                and torch.equal(extras["pooled_output"], pooled))
        want = dict(NO_LAUNCHES, flash_fwd=24)
        runs["comfyui"] = counts
        check("comfyui", same and counts == want, {
            "phase": "cli-comfyui", "load_s": load_s,
            "conditioning_equal": same, "shape": list(embeds.shape),
            "launches": counts, "launches_expected": want})
        del pipe, encoder, node_proj, embeds, extras
        _free()
    if failed:
        raise AssertionError(f"the entry points failed: {failed}")
    return runs


# ------------------------------------------------------------ registry

REGISTRY_STEPS = {"x2i-minicpm-o-2.6-dev": 28}    # the others 4


def phase_registry(pipe, seed: int, dit_state, card: str):
    """The five other MODEL_REGISTRY entries at full width and depth, one
    1024^2 image each through its family's template, tokenizer
    (``ByteTokenizer``) and positions, weights drawn on the card (and
    the media images of ``registry_media``): the
    FLUX.1-schnell entries share one DiT, drawn again from ``dit_state``
    (the bf16 serving DiT's weights), and swap their LM and proj, the last
    LM freed before the next is drawn; x2i-minicpm-o-2.6-dev draws its
    FLUX.1-dev DiT (guidance embedder) after the schnell one is freed, and
    makes its image in its published 28 steps with guidance 3.5 and
    dynamic shifting. The VAE is the pipeline's. Exact launch counts: one
    K1b per LM layer, K1a 57 and K5 115 per DiT step. On the
    x2i-qwenvl2.5-7b entry, before its LM is freed, the decode phases
    run: ``answer``, ``chat``, ``tts`` (conditioned on the chat's streamed
    reply), then ``answer-w8a8``, which quantizes that LM in place."""
    import dataclasses
    import gc
    import zlib

    import torch
    from x2i_torch.convert.load import mllm_encoder
    from x2i_torch.core.config import MODEL_REGISTRY, GenerationConfig
    from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.models.proj import Proj
    from x2i_torch.models.qwen2 import Qwen2LM
    from x2i_torch.params import random_init_
    from x2i_torch.pipeline import X2IPipeline

    dev = torch.device("cuda")
    pipe.flux = None
    gc.collect()
    torch.cuda.empty_cache()
    flux = draw_dit(dit_state)[0]
    counts = {}
    for name, spec in MODEL_REGISTRY.items():
        if name == MODEL:
            continue
        steps = REGISTRY_STEPS.get(name, 4)
        if spec.flux.guidance_embeds:
            flux = None
            gc.collect()
            torch.cuda.empty_cache()
            g = torch.Generator(device=dev).manual_seed(seed + 1)
            flux = random_init_(FluxTransformer2D(dataclasses.replace(
                spec.flux, fused_glue=True), dev), g)
        g = torch.Generator(device=dev).manual_seed(
            seed + zlib.crc32(name.encode()))
        t0 = time.perf_counter()
        lm = random_init_(Qwen2LM(spec.llm, dev), g)
        proj = random_init_(Proj(spec.proj, dev), g)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        family = family_of(name)
        tok = ByteTokenizer(family)
        vl_cfg = vision = None
        if family == "internvl":
            vision = draw_internvl(name, lm, seed, tok)
            vl_cfg = vision.cfg
        elif family == "qwenvl":
            vl_cfg, vision = draw_qwen_tower(name, lm, seed, tok)
        elif name == MINICPM_MODEL:       # the -dev entry: its text alone
            vision = draw_minicpmo(name, lm, seed)
            vl_cfg = vision.cfg
        encoder_fn = mllm_encoder(name, lm, tok, vl_cfg, vision)
        entry = X2IPipeline(
            encoder_fn=encoder_fn, proj=proj, flux=flux, vae=pipe.vae,
            scheduler=FlowMatchEulerScheduler(spec.scheduler),
            gen_cfg=GenerationConfig(height=1024, width=1024,
                                     num_inference_steps=steps),
            encoder_batch_fn=encoder_fn.batch)
        want = expected_launches(False, steps,
                                 lm_layers=spec.llm.num_hidden_layers)
        rec, _, got = run_image(entry, seed, f"registry[{name}]", want,
                                steps=steps, model=name)
        rec.update(lm_draw_s=draw_s, lm_layers=spec.llm.num_hidden_layers,
                   lm_heads=[spec.llm.num_attention_heads,
                             spec.llm.num_key_value_heads],
                   lm_weight_bytes=sum(p.numel() * p.element_size()
                                       for p in lm.parameters()),
                   guidance_embeds=spec.flux.guidance_embeds,
                   dynamic_shifting=spec.scheduler.use_dynamic_shifting)
        emit(rec)
        if got != want:
            raise AssertionError(f"{name} missed its kernels: {got} != "
                                 f"{want}")
        counts[f"registry[{name}]"] = got
        counts.update(registry_media(name, entry, vl_cfg, vision, seed,
                                     card))
        if name == ANSWER_MODEL:
            counts["answer"], bf16_cond = phase_answer(entry, lm, seed, card)
            counts["chat"], spk, stream_s = phase_chat(entry, lm, seed,
                                                       card)
            counts["tts"] = phase_tts(spk, stream_s, seed, card)
            counts["answer-w8a8"] = phase_answer_w8a8(entry, lm, seed, card,
                                                      bf16_cond)
            del bf16_cond
        del entry, encoder_fn, lm, proj, vision
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def _tower_ms(cfg, visual, images=None, video=None):
    """The host half's time for a Qwen2.5-VL request's media (resize,
    patches, window permutation) and the card's for the tower
    (``call_ms`` of ``encode_vision``), with the tower's patch count."""
    import torch
    from x2i_torch.data.qwen_vision import prepare_vision_inputs
    from x2i_torch.models.qwen2_5_vl import encode_vision, vision_tensors
    v = cfg.vision
    t0 = time.perf_counter()
    vin = prepare_vision_inputs(
        images, [video] if video is not None else None,
        patch_size=v.patch_size, merge_size=v.spatial_merge_size,
        temporal_patch_size=v.temporal_patch_size,
        window_size=v.window_size)
    host_ms = (time.perf_counter() - t0) * 1e3
    vt = vision_tensors(vin, "cuda")
    with torch.inference_mode():
        tower_ms = call_ms(lambda: encode_vision(visual, vt), iters=10)
    return {"host_half_ms": host_ms, "tower_ms": tower_ms,
            "tower_patches": int(vt["patches"].shape[0])}


def registry_media(name: str, entry, vl_cfg, vision, seed: int, card: str):
    """The registry entry's images with media, each with exact launch
    counts set to 0 just before and read just after: x2i-internvl2.5-4b
    one imagetext2image (K1b in its 24 ViT and 36 LM layers); each
    Qwen2.5-VL entry one image2image (its tower takes the plain route: no
    launch), and x2i-qwenvl2.5-7b also one video2image of eight 128^2
    frames and one use_answer image after an image input (the decode's
    cache takes the plain attention: no K1b); x2i-minicpm-o-2.6 the
    images of ``minicpm_media``. -> their launch counts."""
    from x2i_torch.core.config import MODEL_REGISTRY

    family = family_of(name)
    if family == "minicpm":
        return (minicpm_media(name, entry, vl_cfg, vision, seed, card)
                if vision is not None else {})
    layers = MODEL_REGISTRY[name].llm.num_hidden_layers
    plain = expected_launches(False, 4, lm_layers=layers)
    runs = []
    if family == "internvl":
        images, route = media(family, seed, 1)
        runs.append(("imagetext2image", {"prompt": PROMPTS[1],
                                         "images": images},
                     image_launches(lm_layers=layers)))
    elif family == "qwenvl":
        images, route = media(family, seed, 1)
        runs.append(("image2image", {"images": images}, plain))
        if name == ANSWER_MODEL:
            video, _ = media(family, seed, 0, frames=VIDEO_FRAMES)
            runs.append(("video2image", {"video": video}, plain))
            runs.append(("imagetext2image", {
                "prompt": PROMPTS[1], "images": images, "use_answer": True},
                expected_launches(False, 4, lm_layers=0)))
    counts = {}
    for task, req, want in runs:
        label = f"registry[{name}] {task}" + (
            " use_answer" if req.get("use_answer") else "")
        reset_counts()
        t0 = time.perf_counter()
        img = entry.run_task(task, **req, seed=seed)
        sec = time.perf_counter() - t0
        got = launch_counts()
        rec = {"phase": label, "model": name, "task": task,
               "use_answer": bool(req.get("use_answer")),
               "host_half": route, "card": card, "s_per_image": sec,
               "image_shape": list(img.shape), "image_std": float(img.std()),
               "launches": got, "launches_expected": want}
        rec.update(_vit_ms(vision, req["images"]) if family == "internvl"
                   else _tower_ms(vl_cfg, vision, req.get("images"),
                                  req.get("video")))
        emit(rec)
        if not (got == want and tuple(img.shape) == (1, 1024, 1024, 3)
                and img.std() > 0):
            raise AssertionError(f"{label} failed: {rec}")
        counts[label] = got
    return counts


MINICPM_MODEL = "x2i-minicpm-o-2.6"
MINICPM_FRAMES = 4             # a video of 4 frames: 4 slices, 256 tokens
AUDIO_SECONDS = 5.0            # 500 mel frames, 125 tokens in 5 spans


def clip(seed: int, seconds: float):
    """A 16 kHz waveform drawn from the seed."""
    import numpy as np
    rng = np.random.default_rng([seed, int(seconds * 1000)])
    return (0.1 * rng.standard_normal(int(16000 * seconds))).astype(
        np.float32)


def _minicpm_inputs(cfg, images=None, audio=None):
    """The host half of MiniCPM-o's towers, timed: the slices' arrays
    (PIL resize and patches, or the arrays as given) and the audio's
    log-mel chunks, as the encoder builds them; -> (vision tensors or
    None, audio tensors or None, {host ms, slices, patches, mel and conv
    frames})."""
    from x2i_torch.data.minicpm_vision import (chunk_audio_mels,
                                               prepare_minicpm_vision)
    from x2i_torch.models.minicpmo import audio_tensors, slice_tensors
    side = cfg.vision.num_patches_per_side
    vt = at = None
    rec = {}
    if images:
        t0 = time.perf_counter()
        vin = prepare_minicpm_vision(images, cfg.llm.hidden_size,
                                     num_patches_per_side=side,
                                     max_size=side)
        rec["vision_host_ms"] = (time.perf_counter() - t0) * 1e3
        vt = slice_tensors(vin, "cuda")
        rec.update(slices=int(vin["num_slices"]),
                   patches=int(vin["patch_mask"].sum()))
    if audio is not None:
        t0 = time.perf_counter()
        mels, lens = chunk_audio_mels(audio)
        rec["audio_host_ms"] = (time.perf_counter() - t0) * 1e3
        at = audio_tensors(mels, lens, "cuda")
        rec.update(mel_frames=int(lens.sum()),
                   conv_frames=int(at["frame_mask"].shape[1]))
    return vt, at, rec


def _minicpm_ms(cfg, vision, images=None, audio=None):
    """The host half's ms and the card's for SigLIP + resampler
    (``vpm_ms``) and for Whisper + projector (``apm_ms``), ``call_ms`` of
    ``encode_images`` and ``encode_audio``."""
    import torch
    vt, at, rec = _minicpm_inputs(cfg, images, audio)
    with torch.inference_mode():
        if vt is not None:
            rec["vpm_ms"] = call_ms(lambda: vision.encode_images(vt))
        if at is not None:
            rec["apm_ms"] = call_ms(lambda: vision.encode_audio(at))
    return rec


def check_minicpm_routes(cfg, vision, encoder_fn, request):
    """MiniCPM-o's stack for ``request`` (images and audio) on the kernel
    route (K1b in the resampler and the LM) against the same encoder on
    the plain attention, and the resampler's features alone the same
    way (SigLIP and Whisper take the plain attention on both); the plain
    route launches no kernel."""
    import torch
    vt, _, _ = _minicpm_inputs(cfg, request.get("images"))
    with torch.inference_mode():
        got, feats = encoder_fn(request), vision.encode_images(vt)
        set_attention_impl(vision, "plain")
        try:
            reset_counts()
            want, want_feats = encoder_fn(request), vision.encode_images(vt)
            plain = launch_counts()
        finally:
            set_attention_impl(vision, "auto")
    rec = {"stack_err": _stack_errors(got, want),
           "layer_err": _layer_errors(got, want),
           "resampler_feature_err": _stack_errors(feats, want_feats),
           "plain_route_launches": sum(plain.values())}
    ok = (all(e[0] <= IMAGE_REL_MAX and e[1] <= IMAGE_REL_MEAN
              for e in (rec["stack_err"], rec["resampler_feature_err"]))
          and rec["plain_route_launches"] == 0
          and bool(torch.isfinite(got).all()))
    return rec, ok


def check_minicpm_batch(entry, vision, seed: int, images, audio, want):
    """An image request and an audio request through the batch path: one
    SigLIP call and one Whisper call for both (counted by hooks), their
    stacks bit for bit the two serial encodes (as measured on the card;
    the distance recorded), and one ``run_batch`` of two 1024^2 images
    with exact launch counts."""
    import torch
    reqs = [{"task": "image2image", "images": images},
            {"task": "audio2image", "audio": audio}]
    vpm, apm = [], []
    hooks = [vision.vpm.register_forward_hook(lambda *a: vpm.append(1)),
             vision.apm.register_forward_hook(lambda *a: apm.append(1))]
    try:
        with torch.inference_mode():
            batched = entry.encoder_fn.batch(reqs)
            calls = (len(vpm), len(apm))
            serial = torch.cat([entry.encoder_fn(r) for r in reqs])
    finally:
        for h in hooks:
            h.remove()
    reset_counts()
    t0 = time.perf_counter()
    imgs = entry.run_batch(reqs, seed=seed)
    sec = time.perf_counter() - t0
    counts = launch_counts()
    rec = {"phase": "registry-minicpm-batch", "model": MINICPM_MODEL,
           "requests": len(reqs), "vpm_apm_calls": list(calls),
           "stack_err_vs_serial": _stack_errors(batched, serial),
           "bit_equal_to_serial": bool(torch.equal(batched, serial)),
           "image_shapes": list(imgs.shape), "seconds": sec,
           "launches": counts, "launches_expected": want}
    emit(rec)
    if not (calls == (1, 1) and counts == want
            and tuple(imgs.shape) == (2, 1024, 1024, 3)
            and all(float(i.std()) > 0 for i in imgs)
            and rec["bit_equal_to_serial"]):
        raise AssertionError(f"the MiniCPM-o batch path failed: {rec}")
    return counts


def plain_attention_ms(cfg, seed: int, card: str):
    """The two attentions of MiniCPM-o's towers that take the plain route
    (no TPU kernel is owed: JAX takes XLA for both), timed on the card
    per layer (``kernel_ms``), with SDPA on the same inputs: SigLIP's
    (1, 1024, 16, 72) under the patch mask (D = 72, which no kernel
    takes) and Whisper's (1, 250, 16, 64) under the frames' mask and the
    1 s chunk bias (a bias takes the plain route)."""
    import torch
    import torch.nn.functional as F
    from x2i_torch.data.minicpm_vision import chunk_bias
    from x2i_torch.models.minicpmo import CHUNK_FRAMES
    from x2i_torch.ops.attention import attention

    g = torch.Generator(device="cuda").manual_seed(seed)
    rec = {"phase": "registry-minicpm-plain-attention", "card": card}
    v, a = cfg.vision, cfg.audio
    for label, s, h, d, layers in (
            ("siglip", 1024, v.num_attention_heads,
             v.hidden_size // v.num_attention_heads, v.effective_layers),
            ("whisper", 250, a.encoder_attention_heads,
             a.d_model // a.encoder_attention_heads, a.encoder_layers)):
        q, k, val = (torch.randn((1, s, h, d), generator=g, device="cuda"
                                 ).to(torch.bfloat16) for _ in range(3))
        mask = torch.ones((1, s), dtype=torch.bool, device="cuda")
        bias = (torch.as_tensor(chunk_bias(s, CHUNK_FRAMES), device="cuda")
                if label == "whisper" else None)
        allowed = mask[:, None, None, :] & (
            True if bias is None else bias == 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, val))
        rec[f"{label}_shape"] = [1, s, h, d]
        rec[f"{label}_plain_ms"] = kernel_ms(
            lambda *t: attention(*t, kv_mask=mask, bias=bias), q, k, val)
        rec[f"{label}_sdpa_ms"] = kernel_ms(
            lambda *t: F.scaled_dot_product_attention(*t, attn_mask=allowed),
            qt, kt, vt)
        rec[f"{label}_layers"] = layers
    emit(rec)
    return rec


def minicpm_media(name: str, entry, cfg, vision, seed: int, card: str):
    """x2i-minicpm-o-2.6's media images on its encoder drawn on the card,
    each at 1024^2 with exact launch counts set to 0 just before and read
    just after: image2image (one 128^2 image: one 448^2 slice, 1024
    patches, 64 tokens), audio2image (5 s drawn from the seed: 500 mel
    frames, 250 conv frames, 125 tokens in five spans of 25), x2image
    (prompt, image and audio) and video2image (4 frames, 256 tokens).
    K1b: one per LM layer and one for the resampler's call where there
    are slices (SigLIP's 72-wide heads and Whisper's chunk bias take the
    plain attention). With each: vpm_ms, apm_ms, the host half's ms,
    s/image; on the x2image request the kernel route against the plain
    attention (``check_minicpm_routes``); then the batch path
    (``check_minicpm_batch``) and the towers' plain attentions
    (``plain_attention_ms``). -> their launch counts."""
    from x2i_torch.core.config import MODEL_REGISTRY

    layers = MODEL_REGISTRY[name].llm.num_hidden_layers
    plain = expected_launches(False, 4, lm_layers=layers)
    slices = dict(plain, flash_fwd=plain["flash_fwd"] + 1)
    images, route = media("minicpm", seed, 1)
    video, _ = media("minicpm", seed, 0, frames=MINICPM_FRAMES)
    audio = clip(seed, AUDIO_SECONDS)
    runs = (("image2image", {"images": images}, slices),
            ("audio2image", {"audio": audio}, plain),
            ("x2image", {"prompt": PROMPTS[1], "images": images,
                         "audio": audio}, slices),
            ("video2image", {"video": video}, slices))
    counts = {}
    for task, req, want in runs:
        label = f"registry[{name}] {task}"
        reset_counts()
        t0 = time.perf_counter()
        img = entry.run_task(task, **req, seed=seed)
        sec = time.perf_counter() - t0
        got = launch_counts()
        rec = {"phase": label, "model": name, "task": task,
               "host_half": route, "card": card, "s_per_image": sec,
               "image_shape": list(img.shape), "image_std": float(img.std()),
               "launches": got, "launches_expected": want,
               **_minicpm_ms(cfg, vision, req.get("images")
                             or req.get("video"), req.get("audio"))}
        ok = True
        if task == "x2image":
            routes, ok = check_minicpm_routes(cfg, vision, entry.encoder_fn,
                                              {"task": task, **req})
            rec.update(routes)
        emit(rec)
        if not (ok and got == want and tuple(img.shape) == (1, 1024, 1024, 3)
                and img.std() > 0):
            raise AssertionError(f"{label} failed: {rec}")
        counts[label] = got
    counts[f"registry[{name}] batch"] = check_minicpm_batch(
        entry, vision, seed, images, audio, slices)
    plain_attention_ms(cfg, seed, card)
    return counts


# ------------------------------------------------------- the LM's decode

ANSWER_MODEL = "x2i-qwenvl2.5-7b"
ANSWER_TOKENS = 128            # the reference's use_answer budget
CHAT_TOKENS = 32               # a multi-turn answer
STREAM_TOKENS = 64             # a streamed reply
# the decode against the cache-less forward (K1b in each layer) over the
# same tokens: the largest and the mean absolute difference of the
# hidden-state stacks, relative to the forward's largest and mean
# magnitude, and the mean one of the first block's output alone. Measured
# on the 7B (random bf16 weights, 28 layers; PERF.md): 0.031 / 0.013 /
# 0.0022 at the answer, 0.025 / 0.014 at the prompt, 0.033 / 0.018 for a
# streamed reply (final layer only). The two attentions round p at other
# points and the difference grows layer by layer; an answer decoded at
# positions one off gives 0.089 / 0.040 / 0.024
# (x2i_torch/tools/decode_spread.py).
ANSWER_REL_MAX, ANSWER_REL_MEAN, ANSWER_REL_LAYER1 = 6e-2, 3e-2, 8e-3


def _answer_request(lm, prompt: str):
    """What the qwenvl text encoder hands the LM for ``prompt``: ids and
    mask (1, 512), 3-D positions (3, 1, 512) and their M-RoPE tables, on
    the LM's device."""
    import numpy as np
    import torch
    from x2i_torch.data.qwen_vision import get_rope_index
    from x2i_torch.models.qwen2_5_vl import Qwen2_5_VLConfig, mrope_tables
    from x2i_torch.models.templates import qwen_chat_messages

    tok = ByteTokenizer("qwenvl")
    enc = tok(tok.apply_chat_template(qwen_chat_messages("text2image",
                                                         prompt)))
    ids = np.asarray([enc["input_ids"]], np.int64)
    mask = np.asarray([enc["attention_mask"]], np.int64)
    dev = lm.embed_tokens.weight.device
    pos3d = torch.as_tensor(get_rope_index(ids, attention_mask=mask)[0],
                            device=dev)
    sec = Qwen2_5_VLConfig().mrope_section
    return (torch.as_tensor(ids, device=dev),
            torch.as_tensor(mask, device=dev).bool(), pos3d,
            mrope_tables(pos3d, lm.cfg.head_dim, lm.cfg.rope_theta, sec))


def _mrope_continued(lm, pos3d, steps: int):
    """M-RoPE tables of the prompt's 3-D positions followed by ``steps``
    answer positions from max(pos3d) + 1, one position on all streams."""
    import torch
    from x2i_torch.models.qwen2_5_vl import Qwen2_5_VLConfig, mrope_tables
    ans = (pos3d.amax(dim=(0, 2))[:, None] + 1
           + torch.arange(steps, device=pos3d.device))
    full = torch.cat([pos3d, ans[None].expand(3, -1, -1)], dim=2)
    return mrope_tables(full, lm.cfg.head_dim, lm.cfg.rope_theta,
                        Qwen2_5_VLConfig().mrope_section)


def _stack_errors(got, want):
    """-> (max |got - want| / max |want|, mean |got - want| / mean |want|)
    over two hidden-state stacks."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return (d.max() / w.max()).item(), (d.mean() / w.mean()).item()


def _layer_errors(got, want):
    """mean |got - want| / mean |want| of each channel of two (B, L+1, S,
    H) stacks: how the difference grows through the layers."""
    d = (got.float() - want.float()).abs().mean(dim=(0, 2, 3))
    return (d / want.float().abs().mean(dim=(0, 2, 3))).tolist()


def _within_answer_bars(stack_err, layer_err=None) -> bool:
    return (stack_err[0] <= ANSWER_REL_MAX and stack_err[1] <= ANSWER_REL_MEAN
            and (layer_err is None or layer_err[1] <= ANSWER_REL_LAYER1))


def _weight_bytes(module) -> int:
    return sum(t.numel() * t.element_size() for t in
               (*module.parameters(), *module.buffers()))


def decode_timing(lm, ids, mask, pos3d, rope):
    """The decode's time by the host clock: ms per token over
    ANSWER_TOKENS steps (the greedy loop of ANSWER_TOKENS steps less the
    same loop of 1, each synchronized) and ``prefill_cached``'s ms
    (``call_ms``), beside the bound: the bytes a step must read (the LM's
    weights, the tied head's table among them, and the cache slots up to
    the step, on average over the steps) over the card's memory rate. ->
    (record, the timed loop's (prefill stack, step stack, tokens):
    ``encode_with_answer``'s decode of the request)."""
    import torch
    from x2i_torch.models.decoding import greedy_decode_with_hiddens

    s0 = ids.shape[1]
    with torch.inference_mode():
        emb = lm.embed(ids)

    def greedy(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy_decode_with_hiddens(
            lm, emb, mask, steps, -1, prefill_rope=rope,
            step_pos0=pos3d.amax(dim=(0, 2)) + 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out[:3]

    greedy(1)
    (full_ms, decoded), (one_ms, _) = greedy(ANSWER_TOKENS), greedy(1)
    with torch.inference_mode():
        prefill_ms = call_ms(lambda: lm.prefill_cached(
            emb, mask, lm.init_cache(1, s0 + ANSWER_TOKENS), rope), iters=3)
    cfg = lm.cfg
    slot_bytes = (2 * cfg.num_hidden_layers * cfg.num_key_value_heads
                  * cfg.head_dim * 2)
    step_bytes = _weight_bytes(lm) + slot_bytes * (s0 + ANSWER_TOKENS / 2)
    rec = {"decode_ms_per_token": (full_ms - one_ms) / (ANSWER_TOKENS - 1),
           "greedy_ms": full_ms, "greedy_1_step_ms": one_ms,
           "prefill_cached_ms": prefill_ms,
           "decode_bound_ms": step_bytes / PEAK_BYTES * 1e3,
           "decode_bound_bytes": step_bytes}
    rec["decode_bound_share"] = (rec["decode_bound_ms"]
                                 / rec["decode_ms_per_token"])
    return rec, decoded


def graph_step_times(step):
    """A decode step's host enqueue time (from an idle card until
    ``step()`` returns; median of 5) against its device time: the same
    step captured once in a CUDA graph and replayed, back to back between
    two events (median of 5 groups of 10), so that the host feeds the card
    no gaps. The larger of the two sets the pace. ``step`` runs under
    ``torch.inference_mode`` and may not synchronize."""
    import torch

    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        torch.cuda.synchronize()
        device = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                graph.replay()
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end) / 10)
        del graph
    rec = {"step_enqueue_ms": statistics.median(enqueue),
           "step_device_ms": statistics.median(device)}
    rec["step_pace"] = ("host" if rec["step_enqueue_ms"]
                        > rec["step_device_ms"] else "device")
    return rec


def step_times(lm, ids, mask, rope):
    """``graph_step_times`` of one mid-answer decode step of the LM (its
    embedding, the cached step and the argmax of the logits)."""
    import torch

    s0 = ids.shape[1]
    with torch.inference_mode():
        cache = lm.init_cache(1, s0 + ANSWER_TOKENS)
        lm.prefill_cached(lm.embed(ids), mask, cache, rope)
        idx = s0 + ANSWER_TOKENS // 2
        slots = torch.arange(s0 + ANSWER_TOKENS, device=ids.device)[None]
        kv = (slots <= idx) & torch.nn.functional.pad(
            mask, (0, ANSWER_TOKENS), value=True)
        token = ids[:, :1]
        pos = torch.full((1, 1), idx, device=ids.device)

    def step():
        return lm.decode_step(lm.embed(token), cache, idx, kv,
                              pos)[1].argmax(-1)

    return graph_step_times(step)


def check_answer(lm, ids, mask, pos3d, decoded):
    """The decode against the cache-less forward (K1b in every layer) over
    the prompt and the decoded answer, mask [prompt mask, ones], under
    the same M-RoPE positions: the decode's step stack against the
    forward's stack at the answer positions, ``prefill_cached``'s stack
    against it at the valid prompt positions, each within ANSWER_REL_MAX
    and ANSWER_REL_MEAN, and its first block within ANSWER_REL_LAYER1.
    decoded: ``decode_timing``'s (prefill stack, step stack, tokens)."""
    import torch

    prefill, steps, tokens = decoded
    with torch.inference_mode():
        full_mask = torch.nn.functional.pad(mask, (0, ANSWER_TOKENS),
                                            value=True)
        before = launch_counts()
        want, _ = lm(torch.cat([ids, tokens], 1), attention_mask=full_mask,
                     rope=_mrope_continued(lm, pos3d, ANSWER_TOKENS))
        torch.cuda.synchronize()
        k1b = launch_counts()["flash_fwd"] - before["flash_fwd"]
    s0, valid = ids.shape[1], mask[0]
    pairs = {"answer": (steps, want[:, :, s0:]),
             "prompt": (prefill[:, :, :s0][:, :, valid],
                        want[:, :, :s0][:, :, valid])}
    rec = {"forward_k1b_launches": k1b,
           "distinct_answer_tokens": int(tokens.unique().numel()),
           "bars_rel_max_mean_layer1": [ANSWER_REL_MAX, ANSWER_REL_MEAN,
                                        ANSWER_REL_LAYER1]}
    ok = k1b == lm.cfg.num_hidden_layers
    for name, (got, ref) in pairs.items():
        rec[f"{name}_vs_forward"] = _stack_errors(got, ref)
        rec[f"{name}_rel_mean_by_layer"] = _layer_errors(got, ref)
        ok = ok and _within_answer_bars(rec[f"{name}_vs_forward"],
                                        rec[f"{name}_rel_mean_by_layer"])
    return rec, ok


def _answer_image(entry, lm, seed: int, label: str, want: dict, card: str):
    """The use_answer request on ``entry``: its decode's time
    (``decode_timing``), whose decode gives the conditioning (the proj of
    the prompt's and the answer's stacks, as ``encode_with_answer``
    computes it) and warms the DiT at its 640 tokens; then the counted
    image through ``text2image(use_answer=True)``, launch counts set to 0
    just before and read just after; then ``step_times``. -> (record,
    whether it passed, the conditioning (pooled, prompt_embeds), the
    request's ids, mask and 3-D positions, the decode's stacks and
    tokens)."""
    import torch
    from x2i_torch.models.decoding import concat_answer_hiddens

    ids, mask, pos3d, rope = _answer_request(lm, PROMPTS[0])
    timing, decoded = decode_timing(lm, ids, mask, pos3d, rope)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cond = entry.proj(concat_answer_hiddens(*decoded[:2]))
    entry.generate(*cond, seed=seed)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img = entry.text2image(PROMPTS[0], seed=seed, use_answer=True)
    sec = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prof = step_times(lm, ids, mask, rope)
    rec = {"phase": label, "model": ANSWER_MODEL, "card": card, "px": 1024,
           "steps": 4, "use_answer": True, "answer_tokens": ANSWER_TOKENS,
           "image_shape": list(img.shape), "image_std": float(img.std()),
           "s_per_image": sec, "warmup_dit_s": warm_s,
           "conditioning_tokens": cond[1].shape[1],
           "joint_tokens": cond[1].shape[1] + (1024 // 16) ** 2,
           "max_memory_allocated": peak, "lm_weight_bytes":
           _weight_bytes(lm), "launches": counts, "launches_expected": want,
           **timing, **prof}
    ok = (tuple(img.shape) == (1, 1024, 1024, 3) and img.std() > 0
          and rec["conditioning_tokens"] == 512 + ANSWER_TOKENS
          and counts == want)
    return rec, ok, cond, (ids, mask, pos3d), decoded


def phase_answer(entry, lm, seed: int, card: str):
    """use_answer reasoning2image on the full-width, full-depth
    Qwen2.5-VL-7B LM (bf16, random weights) and the schnell DiT: the
    512-token prompt's ``prefill_cached`` (the plain attention over the
    cache: no K1b), 128 greedy steps, a conditioning of 640 tokens, one
    1024^2 image with exact launch counts (K1a 57 and K5 115 a DiT step);
    its decode cost (``decode_timing``, ``step_times``) and the decode
    held against the cache-less forward (``check_answer``). -> (counts,
    conditioning)."""
    want = expected_launches(False, 4, lm_layers=0)
    rec, ok, cond, request, decoded = _answer_image(entry, lm, seed,
                                                    "answer", want, card)
    check, check_ok = check_answer(lm, *request, decoded)
    rec.update(check)
    emit(rec)
    if not (ok and check_ok):
        raise AssertionError(f"the use_answer path failed: {rec}")
    return rec["launches"], cond


def check_lm_routes_quant(seed: int):
    """The w8a8 7B LM cut to 2 layers at full width: its 512-token
    ``prefill_cached`` (400 valid) and a decode step through the int8 GEMM
    and K8 against the plain route (``quant_impl="plain"``, plain
    attention) on the same int8 weights, to ``check_routes_quant``'s bar
    (correlation above 0.999, relative L2 below 5e-2); 14 launches of
    each kernel per call on the kernel route, none on the plain one."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.models.qwen2 import Qwen2LM
    from x2i_torch.ops.quant import quantize_module_
    from x2i_torch.params import random_init_

    dev = torch.device("cuda")
    cfg = dataclasses.replace(MODEL_REGISTRY[ANSWER_MODEL].llm,
                              num_hidden_layers=2)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    kern = quantize_module_(random_init_(Qwen2LM(cfg, dev), g), "w8a8")
    plain = Qwen2LM(dataclasses.replace(kern.cfg, quant_impl="plain",
                                        attention_impl="plain"), dev)
    plain.load_state_dict(kern.state_dict())
    emb = torch.randn((1, 512, cfg.hidden_size), generator=g, device=dev,
                      dtype=torch.bfloat16)
    tok = torch.randn((1, 1, cfg.hidden_size), generator=g, device=dev,
                      dtype=torch.bfloat16)
    mask = torch.arange(512, device=dev)[None] < 400
    kv = F.pad(mask, (0, 128))
    kv[:, 512] = True
    pos = torch.full((1, 1), 400, device=dev)
    outs, used = [], []
    for lm in (kern, plain):
        reset_counts()
        cache = lm.init_cache(1, 640)
        pre = lm.prefill_cached(emb, mask, cache)[0]
        step = lm.decode_step(tok, cache, 512, kv, pos)[0]
        outs.append((pre[:, :, :400].float(), step.float()))
        used.append(launch_counts())
    rec = {"phase": "answer-w8a8-reference", "layers": 2, "tokens": 512,
           "kernel_launches": used[0],
           "plain_route_launches": used[1]}
    ok = used[0] == dict(NO_LAUNCHES, int8_gemm=28, quant_rows=28) \
        and not any(used[1].values())
    for name, got, want in zip(("prefill", "decode step"), *outs):
        rel = ((got - want).norm() / want.norm()).item()
        corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()])
                              )[0, 1].item()
        rec[name] = {"rel_l2_err": rel, "corr": corr,
                     "max_abs_err": (got - want).abs().max().item()}
        ok = ok and bool(torch.isfinite(got).all()) and corr > 0.999 \
            and rel < 5e-2
    emit(rec)
    if not ok:
        raise AssertionError(f"the int8 LM's kernel route disagrees with "
                             f"its plain route: {rec}")


def phase_answer_w8a8(entry, lm, seed: int, card: str, bf16_cond):
    """The same LM quantized in place to w8a8 (``quantize_module_``: its 7
    dense layers a block; the tied head stays the bf16 table) and the same
    use_answer request: exact launch counts, the int8 GEMM and K8 once
    per dense layer per LM call (the prefill and 128 steps), its decode
    cost and bound, and the distance of its conditioning from the bf16
    one (an argmax can flip, so it is no bar); then the 2-layer route
    check."""
    from x2i_torch.ops.quant import quantize_module_

    quantize_module_(lm, "w8a8")
    calls = 7 * lm.cfg.num_hidden_layers * (1 + ANSWER_TOKENS)
    want = dict(expected_launches(False, 4, lm_layers=0), int8_gemm=calls,
                quant_rows=calls)
    rec, ok, cond, _, _ = _answer_image(entry, lm, seed, "answer-w8a8",
                                        want, card)
    rec["conditioning_rel_l2_from_bf16"] = [
        ((a.float() - b.float()).norm() / b.float().norm()).item()
        for a, b in zip(cond, bf16_cond)]
    emit(rec)
    if not ok:
        raise AssertionError(f"the w8a8 use_answer path failed: {rec}")
    check_lm_routes_quant(seed)
    return rec["launches"]


def phase_chat(entry, lm, seed: int, card: str):
    """The two chat sessions on the bf16 7B LM. A ``MultiTurnSession`` of
    two turns through the byte tokenizer's chat template with the
    history, CHAT_TOKENS greedy tokens a turn and a 1024^2 image a turn
    (the 544-token conditioning takes K1a on the padded sequence), with
    exact launch counts over the two turns; a ``StreamingSession``
    (``make_qwen2_session``): a system chunk, two user chunks and the
    assistant prompt prefilled at their cache offsets, then STREAM_TOKENS
    generated, whose final-layer states are held against the cache-less
    forward (K1b) over the same tokens to the answer's bars. ms per token
    of each. -> (counts, the streamed reply's last final-layer state (1,
    1, H): the TTS conditioning, the streamed generation's seconds)."""
    import torch
    from x2i_torch.multiturn import MultiTurnSession, chat_tokenize
    from x2i_torch.streaming import make_qwen2_session

    tok = ByteTokenizer("qwenvl")
    detok = lambda ids: tok.decode(ids, skip_special_tokens=True)  # noqa
    image_s = []

    def image(pooled, embeds, seed):
        t0 = time.perf_counter()
        img = entry.generate(pooled, embeds, seed=seed)
        image_s.append(time.perf_counter() - t0)
        return img

    session = MultiTurnSession(lm, chat_tokenize(tok), detok, entry.proj,
                               image, tok.eos_token_id,
                               max_new_tokens=CHAT_TOKENS, seed=seed)
    reset_counts()
    turns = []
    for msg in (PROMPTS[0], "now the same scene at night"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answer, img = session.turn(msg)
        turns.append({"s": time.perf_counter() - t0, "image_s": image_s[-1],
                      "answer_chars": len(answer),
                      "image_ok": tuple(img.shape) == (1, 1024, 1024, 3)
                      and float(img.std()) > 0})
    counts = launch_counts()
    want = {k: 2 * v for k, v in expected_launches(False, 4,
                                                   lm_layers=0).items()}
    for t in turns:
        t["ms_per_token"] = (t["s"] - t["image_s"]) * 1e3 / CHAT_TOKENS

    stream = make_qwen2_session(lm, tok.encode, detok, max_len=512,
                                terminators=[tok.eos_token_id])
    consumed = [
        stream.prefill("chat", "system", "<|im_start|>system\nYou are a "
                       "helpful assistant.<|im_end|>\n"),
        stream.prefill("chat", "user", PROMPTS[1]),
        stream.prefill("chat", "user", ", drawn as a woodcut"),
        stream.prefill("chat", "generate",
                       "<|im_end|>\n<|im_start|>assistant\n")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ids, hidden = stream.generate(STREAM_TOKENS, assistant_prompt="")
    gen_ms = (time.perf_counter() - t0) * 1e3
    prompt = tok.encode("".join(consumed))
    n = len(prompt) + len(ids)
    pad = -n % 128
    dev = hidden.device
    with torch.inference_mode():
        before = launch_counts()["flash_fwd"]
        want_states, _ = lm(
            torch.tensor([prompt + ids + [0] * pad], device=dev),
            attention_mask=torch.arange(n + pad, device=dev)[None] < n)
        k1b = launch_counts()["flash_fwd"] - before
    err = _stack_errors(hidden, want_states[:, -1, len(prompt):n])
    rec = {"phase": "chat", "model": ANSWER_MODEL, "card": card,
           "multiturn": {"turns": turns, "tokens_a_turn": CHAT_TOKENS,
                         "history": len(session.history),
                         "launches": counts, "launches_expected": want},
           "streaming": {"chunks": len(consumed), "prompt_tokens":
                         len(prompt), "generated": len(ids),
                         "ms_per_token": gen_ms / max(len(ids), 1),
                         "vs_forward_rel_max_mean": err,
                         "forward_k1b_launches": k1b}}
    emit(rec)
    if not (all(t["image_ok"] for t in turns) and counts == want
            and len(session.history) == 2 and len(ids) == STREAM_TOKENS
            and k1b == lm.cfg.num_hidden_layers
            and _within_answer_bars(err)):
        raise AssertionError(f"the chat sessions failed: {rec}")
    return counts, hidden[:, -1:].clone(), gen_ms / 1e3



# ------------------------------------------------------------- the speech

TTS_TOKENS = 256               # speak's default budget of audio tokens
TTS_TEXT = ("A lighthouse at dusk, drawn as a woodcut: 3 boats, 12 gulls "
            "and 1 keeper on the rocks below.")
TTS_RATE = 24000               # the vocoder's samples a second
# the card against a CPU float32 run of the same weights and codes: the
# largest absolute difference relative to the CPU's largest magnitude
# (TF32 off on both). Measured on an H100 (PERF.md): 1.2e-6 for the first
# step's logits (9.2e-7 filtered), 2.4e-6 for the teacher-forced cache,
# 9.9e-7 for the step after it, 4.4e-6 for the waveform
TTS_LOGITS_REL, TTS_CACHE_REL, TTS_WAV_REL = 2e-5, 3e-5, 5e-5


def _rel_max(got, want) -> float:
    want = want.float()
    return ((got.float().cpu() - want).abs().max() / want.abs().max()).item()


def draw_tts(seed: int, device):
    """MiniCPM-o's speech modules at full width, drawn from the seed:
    ``ConditionalChatTTS`` (ChatTTSConfig(): 20 layers of 768, 626 audio
    tokens in 4 codebooks, f32), the DVAE and ``VocosVocoder()``."""
    import torch
    from x2i_torch.models.chattts import (DVAE, ChatTTSConfig,
                                          ConditionalChatTTS, VocosVocoder)
    from x2i_torch.params import random_init_
    g = torch.Generator(device=device).manual_seed(seed + 16)
    return (random_init_(ConditionalChatTTS(ChatTTSConfig(), device), g),
            random_init_(DVAE(device=device), g),
            random_init_(VocosVocoder(device=device), g))


def tts_cpu_check(tts, dvae, voc, input_ids, text_mask, spk, codes, wav):
    """The card's speech path against the same weights in float32 on the
    CPU: the first audio step's raw and filtered logits after the text
    prefill, a teacher-forced ``prefill_audio`` of the card's codes (the
    cache slots it writes) and the step after it, and the DVAE and
    vocoder's waveform of the same codes. -> record."""
    import torch
    from x2i_torch.models.chattts import (DVAE, ConditionalChatTTS,
                                          VocosVocoder)
    cfg = tts.cfg
    cpu = [ConditionalChatTTS(cfg), DVAE(), VocosVocoder()]
    for mod, src in zip(cpu, (tts, dvae, voc)):
        mod.load_state_dict(src.state_dict())
    ctts, cdvae, cvoc = cpu
    cond, n = cfg.condition_length, codes.shape[1]
    pos = torch.arange(input_ids.shape[1])[None]
    out, logits, filtered, caches = {}, {}, {}, {}
    for name, mod in (("card", tts), ("cpu", ctts)):
        dev = mod.device
        with torch.inference_mode():
            cache = mod.prefill_text(input_ids.to(dev), pos.to(dev),
                                     mod.init_cache(cond + n + 1),
                                     spk.to(dev))
            bos = mod.emb_text(torch.full((1, 1), cfg.audio_bos_token_id,
                                          device=dev))
            raw, _ = mod.decode_step(bos, cache, cond - 1, text_mask.to(dev))
            filtered[name] = mod.filter_logits(
                raw, torch.zeros((cfg.num_vq, 1), dtype=torch.int64,
                                 device=dev),
                torch.zeros(1, device=dev), 0, 10, 1.0)
            logits[name] = raw
            cache = mod.prefill_audio(codes.to(dev), cache, cond - 1,
                                      text_mask.to(dev))
            caches[name] = [c[:, :, cond - 1:cond + n] for c in cache]
            nxt, _ = mod.decode_step(mod.embed_code(codes[:, -1:].to(dev)),
                                     cache, cond + n, text_mask.to(dev))
            out[name] = nxt
    keep = torch.isfinite(filtered["card"].cpu())
    with torch.inference_mode():
        cpu_wav = cvoc(cdvae.decode(codes.cpu()))
    return {
        "first_logits_rel_max": _rel_max(logits["card"], logits["cpu"]),
        "filtered_kept_equal": bool(torch.equal(
            keep, torch.isfinite(filtered["cpu"]))),
        "filtered_rel_max": _rel_max(filtered["card"].cpu()[keep],
                                     filtered["cpu"][keep]),
        "prefill_audio_cache_rel_max": max(
            _rel_max(a, b) for a, b in zip(caches["card"], caches["cpu"])),
        "after_audio_logits_rel_max": _rel_max(out["card"], out["cpu"]),
        "wav_rel_max": _rel_max(wav, cpu_wav)}


def phase_tts(spk, stream_s: float, seed: int, card: str):
    """MiniCPM-o's speech half at full width on the card (``draw_tts``),
    conditioned on the chat phase's streamed reply (its last final-layer
    state of the 7B LM, (1, 1, 3584)): ``TTSPipeline.speak`` of TTS_TEXT
    through ``ByteTokenizer`` ids with TTS_TOKENS audio tokens and a
    ``torch.Generator``, launch counts set to 0 just before and read just
    after (none: the GPT's cached attention is the plain one, the codec
    and vocoder are cuDNN's and cuBLAS's). Then its costs: ms per audio
    token (``generate`` of TTS_TOKENS steps with eos masked throughout,
    less the same of 1 step), a step's host enqueue against its device
    time (``graph_step_times``), the bound of a step (the GPT's weights
    and the cache slots read, over the memory rate), ``prefill_text``'s,
    the DVAE decode's and the vocoder's ms (``call_ms``), the real-time
    factor (seconds of audio a second of ``speak``, after one warm-up
    ``speak`` of the same request), the peak memory over the phase's
    start and the speech's share of a streamed turn (the chat's streamed
    reply plus ``speak``); and the card against the CPU
    (``tts_cpu_check``).
    -> counts."""
    import torch
    from x2i_torch.pipeline import resolve_device
    from x2i_torch.streaming import TTSPipeline

    dev = resolve_device()                  # TF32 off
    before = torch.cuda.memory_allocated()
    tts, dvae, voc = draw_tts(seed, dev)
    cfg = tts.cfg
    tok = ByteTokenizer("minicpm")
    pipe = TTSPipeline(tts, dvae, voc, tok.encode)

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)

    pipe.speak(TTS_TEXT, spk, gen(), max_audio_tokens=TTS_TOKENS)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    wav, codes, n = pipe.speak(TTS_TEXT, spk, gen(),
                               max_audio_tokens=TTS_TOKENS)
    torch.cuda.synchronize()
    speak_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    from x2i_torch.data.tts_text import replace_numbers_with_text
    ids = tok.encode(replace_numbers_with_text(TTS_TEXT))
    reserved = cfg.streaming_text_reserved_len
    input_ids = torch.tensor([[pipe.bos_token_id, cfg.spk_emb_token_id]
                              + ids + [0] * (reserved - len(ids))],
                             device=dev)
    text_mask = torch.arange(reserved, device=dev) < len(ids)
    pos = torch.arange(input_ids.shape[1], device=dev)[None]
    cond = cfg.condition_length

    def prefilled(extra):
        return tts.prefill_text(input_ids, pos, tts.init_cache(cond + extra),
                                spk)

    def generate(steps):
        cache = prefilled(TTS_TOKENS)
        buf = torch.zeros((1, steps, cfg.num_vq), dtype=torch.int64,
                          device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, got, _ = tts.generate(buf, cache, cond - 1, text_mask, gen(),
                                    steps, min_new_tokens=steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, got

    generate(1)
    (full_ms, full_n), (one_ms, _) = generate(TTS_TOKENS), generate(1)
    with torch.inference_mode():
        prefill_ms = call_ms(lambda: prefilled(TTS_TOKENS), iters=3)
        mel = dvae.decode(codes)
        dvae_ms = call_ms(lambda: dvae.decode(codes), iters=3)
        voc_ms = call_ms(lambda: voc(mel), iters=3)
        cache = prefilled(TTS_TOKENS)
        idx = cond + TTS_TOKENS // 2
        last = codes[:, -1:]
        gumbel = torch.empty((cfg.num_vq, cfg.num_audio_tokens),
                             device=dev).exponential_().log_().neg_()
        window = torch.zeros((cfg.num_vq, 1), dtype=torch.int64,
                             device=dev)
        valid = torch.zeros(1, device=dev)

    def step():
        logits, _ = tts.decode_step(tts.embed_code(last), cache, idx,
                                    text_mask)
        return (tts.filter_logits(logits, window, valid, idx, 10, 1.0)
                + gumbel).argmax(-1)

    prof = graph_step_times(step)
    slot = 2 * cfg.num_hidden_layers * cfg.hidden_size * 4
    step_bytes = _weight_bytes(tts) + slot * (cond + TTS_TOKENS / 2)
    check = tts_cpu_check(tts, dvae, voc, input_ids, text_mask, spk, codes,
                          wav)
    samples = wav.shape[1]
    rec = {"phase": "tts", "card": card, "layers": cfg.num_hidden_layers,
           "hidden": cfg.hidden_size, "dtype": str(cfg.dtype),
           "weight_bytes": {"gpt": _weight_bytes(tts),
                            "dvae": _weight_bytes(dvae),
                            "vocoder": _weight_bytes(voc)},
           "spk_hidden": list(spk.shape), "text_tokens": len(ids),
           "audio_tokens": n, "audio_tokens_max": TTS_TOKENS,
           "codes_shape": list(codes.shape), "samples": samples,
           "audio_s": samples / TTS_RATE, "speak_s": speak_s,
           "real_time_factor": samples / TTS_RATE / speak_s,
           "ms_per_audio_token": (full_ms - one_ms) / (TTS_TOKENS - 1),
           "generate_ms": full_ms, "generate_1_step_ms": one_ms,
           "generate_tokens": full_n, "prefill_text_ms": prefill_ms,
           "dvae_decode_ms": dvae_ms, "vocoder_ms": voc_ms,
           "step_bound_ms": step_bytes / PEAK_BYTES * 1e3,
           "step_bound_bytes": step_bytes, **prof,
           "max_memory_allocated": peak,
           "peak_over_phase_start": peak - before, "stream_reply_s": stream_s,
           "speech_share_of_turn": speak_s / (stream_s + speak_s),
           "launches": counts, "vs_cpu": check,
           "bars": {"logits": TTS_LOGITS_REL, "cache": TTS_CACHE_REL,
                    "wav": TTS_WAV_REL}}
    emit(rec)
    finite = bool(torch.isfinite(wav).all())
    if not (finite and 1 <= n <= TTS_TOKENS and full_n == TTS_TOKENS
            and tuple(codes.shape) == (1, n, cfg.num_vq)
            and samples == (2 * n - 1) * voc.hop_length
            and counts == NO_LAUNCHES
            and check["filtered_kept_equal"]
            and max(check["first_logits_rel_max"],
                    check["filtered_rel_max"],
                    check["after_audio_logits_rel_max"]) <= TTS_LOGITS_REL
            and check["prefill_audio_cache_rel_max"] <= TTS_CACHE_REL
            and check["wav_rel_max"] <= TTS_WAV_REL):
        raise AssertionError(f"the speech phase failed: {rec}")
    del tts, dvae, voc, pipe, cache
    return counts

# ------------------------------------------------------------- parallel
# The parallel layer on one card, in its one-process form: one process
# holds every member of an axis (``parallel/axis.py::LocalAxis``).

RING = 4                       # members of the ring and stages of the pipe
RING_HEADS, RING_D = 24, 128
# bars set from the card's measurement (PERF.md section 6; NVIDIA H100
# 80GB HBM3, 700 W), a few times what it gave: the ring against the whole
# kernels, both bf16 with f32 accumulators. o: 9.8e-4 max and 4.5e-5 mean
# absolute error; lse 3.8e-6 (log2 units); dq, dk, dv 5.3e-3 max and
# 1.7e-4 mean of the largest |gradient|; the 2048^2 ring image 8.3e-3
# relative L2 (mean 0.72 levels) from the ring of one's; the pipelined
# forward bit for bit the plain one
RING_O_MAX, RING_O_MEAN = 4e-3, 2e-4
RING_LSE_MAX = 5e-5
RING_GRAD_REL_MAX, RING_GRAD_REL_MEAN = 1.5e-2, 1e-3
RING_IMAGE_REL_L2 = 2.5e-2
PIPE_REL_L2 = 1e-3


def ring_launches(n: int, kv_tokens: int, backward: bool = False,
                  d: int = RING_D, f32: bool = False) -> dict:
    """One ring attention's launches: n^2 pair forwards (K1 with the lse,
    or K2 with the lse above 8192 kv tokens a shard) and, backward, n^2
    K3 and K4, under the names of head dim d and the f32 instances."""
    from x2i_torch.ops.flash_attention import launch_name
    sfx = "_f32" if f32 else ""
    fwd = ("flash_chunked" if kv_tokens > 8192 else "flash_fwd_lse") + sfx
    want = dict(NO_LAUNCHES, **{launch_name(fwd, d): n * n})
    if backward:
        want.update({launch_name(name + sfx, d): n * n
                     for name in ("flash_bwd_dq", "flash_bwd_dkv")})
    return want


def _ring_record(label, ring, s, heads=RING_HEADS, d=RING_D, **fields):
    return {"phase": "parallel", "check": "ring-kernels", "case": label,
            "ring": ring, "shape": [1, heads, s, d], "shard": s // ring,
            **fields}


def _ring_fwd_bwd(label, q, k, v, do, ring, recs, time_plain=True):
    """A ring of ``ring`` members (the one-process form) over (B, S, H, D)
    q, k, v, forward and reverse-ring backward of sum(o * do) by autograd,
    on the card's kernels, against the whole sequence's: K1 with the lse
    (K2 with the lse above ``MAX_KV_SEQ``) and K3 / K4. o within
    ``RING_O_MAX`` / ``RING_O_MEAN``, the lse within ``RING_LSE_MAX``, the
    gradients within ``RING_GRAD_REL_MAX`` / ``RING_GRAD_REL_MEAN`` of the
    largest |gradient|, the launches exact (``ring_launches``). Each ring's
    time (``kernel_ms``) beside the whole kernels', the plain pair
    functions' (``time_plain``: their f32 scores fit), SDPA's and the whole
    sequence's bound. -> the ring's launches."""
    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import flash_attention as fa
    from x2i_torch.ops import ring_attention as ra
    from x2i_torch.parallel.axis import LocalAxis

    _, s, heads, d = q.shape
    f32 = q.dtype == torch.float32
    axis = LocalAxis(ring, "tensor")
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    chunked = s > fa.MAX_KV_SEQ

    def whole_fwd(*t):
        return (fa.flash_forward_chunked(*t, return_lse=True) if chunked
                else fa.flash_forward_lse(*t))

    o_w, lse_w = whole_fwd(qt, kt, vt)
    grads_w = fa.flash_backward(qt, kt, vt, None, o_w, lse_w, dot)
    reset_counts()
    ins = [x.detach().requires_grad_() for x in (q, k, v)]
    o_r = ra.ring_attention(*ins, axis)
    grads_r = torch.autograd.grad(o_r, ins, do)
    torch.cuda.synchronize()
    counts = launch_counts()
    _, lse_r = ra.ring_forward_lse(qt, kt, vt, axis)
    diff = (o_r.float() - o_w.transpose(1, 2).float()).abs()
    errs = [_rel_errors(a, b.transpose(1, 2))
            for a, b in zip(grads_r, grads_w)]
    lib_in = [x.contiguous() for x in (qt, kt, vt, dot)]

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c)

    def sdpa_fb(a, b, c, d_):
        args = [t.detach().requires_grad_() for t in (a, b, c)]
        return torch.autograd.grad(sdpa(*args), args, d_)

    sfx = "_f32" if f32 else ""
    fwd_name = fa.launch_name(("flash_chunked" if s // ring > fa.MAX_KV_SEQ
                               else "flash_fwd_lse") + sfx, d)
    bwd_names = [fa.launch_name(n + sfx, d)
                 for n in ("flash_bwd_dq", "flash_bwd_dkv")]
    flops = 4.0 * s * s * d * heads
    fwd = _ring_record(
        f"{label}, ring of {ring}, forward", ring, s, heads, d,
        kernel=fwd_name, dtype=str(q.dtype), max_abs_err=diff.max().item(),
        mean_abs_err=diff.mean().item(),
        lse_max_abs_err=(lse_r - lse_w).abs().max().item(),
        ms=kernel_ms(lambda *t: ra.ring_forward_lse(*t, axis), qt, kt, vt),
        whole_ms=kernel_ms(whole_fwd, qt, kt, vt),
        plain_ms=(kernel_ms(lambda *t: ra.ring_forward_lse(
            *t, axis, implementation="plain"), qt, kt, vt)
            if time_plain else None),
        library_ms=kernel_ms(sdpa, *lib_in[:3]),
        library="SDPA forward on the whole sequence (no lse output)")
    fwd["bound_ms"], fwd["bound_by"] = bound(
        flops, nbytes(qt, kt, vt, o_w, lse_w))
    rate(fwd, flops)
    res = (o_w, lse_w, dot)

    def ring_bwd(*t):
        return ra.ring_grads(*t, axis)

    bwd = _ring_record(
        f"{label}, ring of {ring}, backward", ring, s, heads, d,
        kernel="+".join(bwd_names), dtype=str(q.dtype),
        max_abs_err=max((a.float() - b.transpose(1, 2).float()).abs().max()
                        .item() for a, b in zip(grads_r, grads_w)),
        max_rel_err=max(e[0] for e in errs),
        mean_rel_err=max(e[1] for e in errs),
        ms=kernel_ms(ring_bwd, qt, kt, vt, *res),
        whole_ms=kernel_ms(lambda a, b, c, o, l, d_: fa.flash_backward(
            a, b, c, None, o, l, d_), qt, kt, vt, *res),
        plain_ms=(kernel_ms(lambda *t: ra.ring_grads(
            *t, axis, implementation="plain"), qt, kt, vt, *res)
            if time_plain else None),
        library_ms=kernel_ms(sdpa_fb, *lib_in) - kernel_ms(sdpa,
                                                           *lib_in[:3]),
        library="SDPA backward: forward + backward by autograd minus the "
                "forward")
    bwd["bound_ms"], bwd["bound_by"] = bound(
        14.0 * s * s * d * heads,
        nbytes(qt, kt, vt, dot, o_w, lse_w, lse_w, *grads_w))
    rate(bwd, 14.0 * s * s * d * heads)
    fwd["launches"] = bwd["launches"] = counts
    for rec in (fwd, bwd):
        emit(rec)
    want = ring_launches(ring, s // ring, backward=True, d=d, f32=f32)
    if not (counts == want and fwd["max_abs_err"] <= RING_O_MAX
            and fwd["mean_abs_err"] <= RING_O_MEAN
            and fwd["lse_max_abs_err"] <= RING_LSE_MAX
            and bwd["max_rel_err"] <= RING_GRAD_REL_MAX
            and bwd["mean_rel_err"] <= RING_GRAD_REL_MEAN
            and all(bool(torch.isfinite(t).all()) for t in (o_r, *grads_r))):
        raise AssertionError(f"ring-kernels, {label}: {fwd} {bwd} "
                             f"(launches expected {want})")
    recs.setdefault(fwd_name, []).append(dict(fwd))
    for name in bwd_names:
        recs.setdefault(name, []).append(dict(bwd))
    return counts


def check_ring_kernels(g, recs):
    """``ring-kernels``: the ring of ``ops/ring_attention.py`` on the
    card's kernels against the whole sequence's (``_ring_fwd_bwd``):
    (1, 24, 4608, 128) over a ring of 4 (1152-token shards), forward and
    backward; at 2048^2 (16,896 tokens), forward only, a ring of 4
    (4224-token shards, K1 with the lse) and a ring of 2 (8448, K2 with the
    lse) against K2 with the lse on the whole sequence. Then the f32 ring
    pairs (f32 tensors take the kernels' f32 instances) at (1, 24, 4608,
    128) over a ring of 4; and head dim 256 (the 12 x 256 DiT): a ring of 4
    at (1, 12, 4608, 256) and a ring of 2 at (1, 12, 16896, 256) (K2 with
    the lse on 8448-token pairs, K3 and K4 on them), each forward and
    backward. Each ring's time stands beside the whole kernels', the
    ring's plain pair functions', SDPA's and the whole sequence's bound
    (the ring does the same work in n^2 launches and the merges). ->
    {run label: launches}."""
    import torch
    import torch.nn.functional as F
    from x2i_torch.ops import flash_attention as fa
    from x2i_torch.ops import ring_attention as ra
    from x2i_torch.parallel.axis import LocalAxis

    dev = torch.device("cuda")

    def randn(s, heads=RING_HEADS, d=RING_D, dtype=torch.bfloat16):
        return torch.randn((1, s, heads, d), generator=g, device=dev,
                           dtype=dtype)

    runs = {}
    s = 512 + (1024 // 16) ** 2
    runs["ring-4608"] = _ring_fwd_bwd(
        "DiT 1024^2", *(randn(s) for _ in range(4)), RING, recs)
    torch.cuda.empty_cache()

    s = 512 + (2048 // 16) ** 2
    q, k, v = (randn(s).transpose(1, 2) for _ in range(3))
    o_w, lse_w = fa.flash_forward_chunked(q, k, v, return_lse=True)
    lib_in = [x.contiguous() for x in (q, k, v)]
    flops = 4.0 * s * s * RING_D * RING_HEADS
    whole_ms = kernel_ms(lambda *t: fa.flash_forward_chunked(
        *t, return_lse=True), q, k, v)
    library_ms = kernel_ms(lambda *t: F.scaled_dot_product_attention(*t),
                           *lib_in)
    for ring in (RING, 2):
        axis = LocalAxis(ring, "tensor")
        reset_counts()
        o_r, lse_r = ra.ring_forward_lse(q, k, v, axis)
        torch.cuda.synchronize()
        counts = launch_counts()
        runs[f"ring-2048-{ring}"] = counts
        diff = (o_r.float() - o_w.float()).abs()
        kernel = "flash_chunked" if s // ring > 8192 else "flash_fwd_lse"
        rec = _ring_record(
            f"DiT 2048^2, ring of {ring}, forward", ring, s, kernel=kernel,
            max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
            lse_max_abs_err=(lse_r - lse_w).abs().max().item(),
            ms=kernel_ms(lambda *t: ra.ring_forward_lse(*t, axis), q, k, v),
            whole_ms=whole_ms, whole="K2 with the lse on the whole sequence",
            # the plain pair functions' f32 scores at 2048^2 would take
            # 3.4 GB a pair (ring of 4), 13.7 GB (ring of 2): timed at 1024^2
            plain_ms=None, library_ms=library_ms,
            library="SDPA forward on the whole sequence (no lse output)",
            launches=counts)
        rec["bound_ms"], rec["bound_by"] = bound(
            flops, nbytes(q, k, v, o_w, lse_w))
        rate(rec, flops)
        emit(rec)
        want = ring_launches(ring, s // ring)
        if not (counts == want and rec["max_abs_err"] <= RING_O_MAX
                and rec["mean_abs_err"] <= RING_O_MEAN
                and rec["lse_max_abs_err"] <= RING_LSE_MAX
                and bool(torch.isfinite(o_r).all())):
            raise AssertionError(f"ring-kernels at {s} tokens: {rec} "
                                 f"(launches expected {want})")
        recs.setdefault(kernel, []).append(dict(rec))
        del o_r, lse_r, diff
    del q, k, v, o_w, lse_w, lib_in
    torch.cuda.empty_cache()

    s = 512 + (1024 // 16) ** 2
    runs["ring-4608-f32"] = _ring_fwd_bwd(
        "DiT 1024^2 f32", *(randn(s, dtype=torch.float32) for _ in range(4)),
        RING, recs)
    torch.cuda.empty_cache()
    heads, d = D256["num_attention_heads"], 256
    runs["ring-4608-d256"] = _ring_fwd_bwd(
        "12 x 256 DiT 1024^2", *(randn(s, heads, d) for _ in range(4)), RING,
        recs)
    torch.cuda.empty_cache()
    s = 512 + (2048 // 16) ** 2
    runs["ring-16896-d256"] = _ring_fwd_bwd(
        "12 x 256 DiT 2048^2", *(randn(s, heads, d) for _ in range(4)), 2,
        recs, time_plain=False)
    torch.cuda.empty_cache()
    return runs


def ring_image(pipe, seed: int, card: str):
    """``ring-image``: a 2048^2, 4-step bf16 image with ``ring_sequence``
    over a ring of 4 (every attention 16 pairs of 4224 tokens, K1 with the
    lse), against the same pipeline with a ring of one member (the whole
    attention, K2) from the same seed and noise. Both take the unfused
    glue and the norm and rope outside the kernel, so that the attention's
    decomposition is the only difference. The DiT's serving config is set
    back after. -> {label: launches}."""
    import numpy as np
    import torch
    from x2i_torch.parallel.axis import LocalAxis

    px, steps = 2048, 4
    flux = pipe.flux
    req = {"task": "text2image", "prompt": PROMPTS[0]}
    size = dict(height=px, width=px, num_steps=steps)
    out, runs = {}, {}
    flux.replace_config(ring_sequence=True)
    try:
        for ring in (RING, 1):
            flux.set_ring_axis(LocalAxis(ring, "tensor"))
            reset_counts()
            t0 = time.perf_counter()
            out[ring] = pipe.run_task(**req, seed=seed, **size)
            out[f"s{ring}"] = time.perf_counter() - t0
            runs[ring] = launch_counts()
    finally:
        flux.set_ring_axis(None)
        flux.replace_config(ring_sequence=False)
    a, b = (x.astype(np.float32) for x in (out[RING], out[1]))
    levels = np.abs(a - b)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    blocks = flux.cfg.num_layers + flux.cfg.num_single_layers
    want = {RING: dict(NO_LAUNCHES, flash_fwd=24,
                       flash_fwd_lse=blocks * RING * RING * steps),
            1: dict(NO_LAUNCHES, flash_fwd=24,
                    flash_chunked=blocks * steps)}
    rec = {"phase": "parallel", "check": "ring-image", "px": px,
           "steps": steps, "ring": RING, "s_per_image_ring": out[f"s{RING}"],
           "s_per_image_ring_of_one": out["s1"],
           "first_call": "each image is its route's first (no warm-up)",
           "image_shape": list(out[RING].shape),
           "max_level_diff": float(levels.max()),
           "mean_level_diff": float(levels.mean()), "rel_l2": rel,
           "launches": runs[RING], "launches_ring_of_one": runs[1],
           "card": card}
    emit(rec)
    if (runs[RING] != want[RING] or runs[1] != want[1]
            or out[RING].shape != (1, px, px, 3) or rel > RING_IMAGE_REL_L2
            or float(a.std()) == 0.0):
        raise AssertionError(f"ring-image is wrong: {rec} (launches "
                             f"expected {want})")
    return {"ring-image": runs[RING], "ring-image-1": runs[1]}


def pipeline_forward(pipe, seed: int, card: str):
    """``pipeline-forward``: one full-width DiT forward at 1024^2, batch 2,
    through ``flux_pipeline_forward`` on 4 local stages (19 double blocks
    padded to 20, 38 single to 40; one sample a microbatch), against the
    plain forward on the same inputs, with the serving config (K1a, K5).
    -> {label: launches}."""
    import torch
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.models.flux import flux_pipeline_forward
    from x2i_torch.parallel.axis import LocalAxis

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 19)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    px, b = 1024, 2
    s_img = (px // 16) ** 2
    args = (rnd(b, s_img, 64), rnd(b, 512, 4096), rnd(b, 768),
            torch.full((b,), 0.75, device=dev),
            prepare_latent_image_ids(px // 8, px // 8, dev),
            torch.zeros((512, 3), device=dev))
    axis = LocalAxis(RING, "stage")
    with torch.inference_mode():
        reset_counts()
        got = flux_pipeline_forward(pipe.flux, *args, axis=axis)
        torch.cuda.synchronize()
        counts = launch_counts()
        reset_counts()
        want = pipe.flux(*args)
        torch.cuda.synchronize()
        plain_counts = launch_counts()
        pipe_ms = call_ms(lambda: flux_pipeline_forward(pipe.flux, *args,
                                                        axis=axis), iters=3)
        plain_ms = call_ms(lambda: pipe.flux(*args), iters=3)
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    n2, n1 = pipe.flux.cfg.num_layers, pipe.flux.cfg.num_single_layers
    expect = dict(NO_LAUNCHES, flash_fwd_rope=(n2 + n1) * b,
                  ln_mod=(4 * n2 + n1) * b + 1)
    rec = {"phase": "parallel", "check": "pipeline-forward", "px": px,
           "batch": b, "stages": RING,
           "padded_layers": [-(-n2 // RING) * RING, -(-n1 // RING) * RING],
           "pipeline_ms": pipe_ms, "plain_ms": plain_ms, "rel_l2": rel,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "finite": bool(torch.isfinite(got).all()), "launches": counts,
           "launches_plain": plain_counts, "card": card}
    emit(rec)
    if not (rec["finite"] and rel <= PIPE_REL_L2 and counts == expect):
        raise AssertionError(f"pipeline-forward is wrong: {rec} (launches "
                             f"expected {expect})")
    return {"pipeline-forward": counts}


def mesh_serving(pipe, seed: int):
    """``mesh`` (serving): ``make_mesh()`` without torchrun's environment
    is the 1 x 1 x 1 mesh over NCCL; ``with_mesh`` generate at 512^2,
    batch 2, equals the plain generate bit for bit. The group is
    destroyed after."""
    import numpy as np
    import torch.distributed as dist
    from x2i_torch.core.mesh import make_mesh

    mesh = make_mesh()
    try:
        reqs = [{"prompt": p} for p in PROMPTS[:2]]
        size = dict(height=512, width=512, num_steps=4, seed=seed)
        want = pipe.run_batch(reqs, **size)
        got = pipe.with_mesh(mesh).run_batch(reqs, **size)
        rec = {"phase": "parallel", "check": "mesh-serving",
               "backend": dist.get_backend(),
               "mesh": list(mesh.mesh.shape),
               "axes": list(mesh.mesh_dim_names),
               "image_shape": list(got.shape),
               "bit_equal": bool(np.array_equal(got, want))}
    finally:
        dist.destroy_process_group()
    emit(rec)
    if not (rec["bit_equal"] and rec["mesh"] == [1, 1, 1]
            and rec["backend"] == "nccl" and rec["image_shape"][0] == 2):
        raise AssertionError(f"mesh serving is wrong: {rec}")


def parallel_training(teacher_fn, student_fn, state, batch, seed: int,
                      card: str):
    """The parallel phase's training checks on the distillation phase's
    full-width trainer (its split step): ``mesh`` -- two steps through
    ``TrainLoop(mesh=make_mesh())`` (the 1 x 1 x 1 mesh over NCCL) equal
    two without a mesh, bit for bit (the proj and the optimizer state);
    ``disaggregated`` -- the one-process pools with both on cuda:0: the
    first step's loss against the colocated step's from the same draws
    (rtol 1e-4, JAX's bar), then three steps through ``train_stream``
    (the teacher in the loader's thread). The state is set back to where
    it was before each run."""
    import itertools

    import torch
    import torch.distributed as dist
    from x2i_torch.core.checkpointing import fill, to_tree
    from x2i_torch.core.mesh import make_mesh
    from x2i_torch.parallel.disaggregated import DisaggregatedDistill
    from x2i_torch.train.runner import TrainLoop, step_noise

    def step_fn(s, b, noise):
        return student_fn(s, b, teacher_fn(b, noise), noise)

    start = to_tree(state)
    t0 = time.perf_counter()
    mesh = make_mesh()
    try:
        runs = []
        for m in (mesh, None):
            state = fill(state, start)
            TrainLoop(step_fn, state, itertools.repeat(batch), seed=seed,
                      mesh=m, log_every=1).run(state.step + 2)
            runs.append(to_tree(state))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    rec = {"phase": "parallel", "check": "mesh-train", "backend": backend,
           "steps": 2, "bit_equal": _tree_bytes_equal(*runs),
           "max_abs_diff": _tree_max_diff(*runs),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not rec["bit_equal"]:
        raise AssertionError(f"TrainLoop(mesh=) differs from TrainLoop: "
                             f"{rec}")

    t0 = time.perf_counter()
    state = fill(state, start)
    noise = step_noise(seed, 100)
    _, colocated = step_fn(state, batch, noise)
    colocated = float(colocated["loss"])
    state = fill(state, start)
    dd = DisaggregatedDistill(teacher_fn, student_fn, None, None, state,
                              n_infer_devices=1,
                              devices=["cuda:0", "cuda:0"])
    first = float(dd.step(dd.train_batch(batch), dd.teacher_step(batch,
                                                                 noise),
                          noise)["loss"])
    stream, step_s = [], []
    t1 = time.perf_counter()
    for i, (tb, tout) in enumerate(dd.train_stream(
            itertools.repeat(batch, 3), (step_noise(seed, 101 + j)
                                         for j in itertools.count()))):
        stream.append(float(dd.step(tb, tout, step_noise(seed, 101 + i))
                            ["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
    rec = {"phase": "parallel", "check": "disaggregated",
           "pools": [dd.infer.size, dd.train.size],
           "devices": [str(d) for d in dd.infer.devices + dd.train.devices],
           "colocated_loss": colocated, "first_loss": first,
           "rel_diff": abs(first - colocated) / abs(colocated),
           "stream_losses": stream, "stream_step_s": step_s,
           "seconds": time.perf_counter() - t0, "card": card}
    emit(rec)
    state = fill(dd.state, start)
    if not (rec["rel_diff"] <= 1e-4 and len(stream) == 3
            and all(math.isfinite(x) for x in stream)):
        raise AssertionError(f"the disaggregated pools are wrong: {rec}")
    return state


# ------------------------------------------------------ tensor parallel
# The DiT under shard_activations / shard_sequence over a tensor axis of
# TP members held by one process (``LocalAxis``), against the flags over
# an axis of one member (the unsharded blocks, the glue unfused as under
# the flags) from the same seed and noise. The bar is the ring image's.

TP = 4
TP_IMAGE_REL_L2 = RING_IMAGE_REL_L2
TP_FLAGS = {"tp": dict(shard_activations=True),
            "sp": dict(shard_sequence=True),
            "tp+sp": dict(shard_activations=True, shard_sequence=True)}


def tensor_launches(flags: str, members: int, px: int = 1024,
                    quantized=False, steps: int = 4, n2: int = 19,
                    n1: int = 38) -> dict:
    """One image's launches with ``flags`` over ``members`` (the glue
    unfused: no K5): each member's attention a block a step (K2 above 8192
    joint tokens, K1c for a member's query rows under ``shard_sequence``
    alone: the rope outside the kernel, else K1a), the LM's 24 K1b; in
    w8 and w4 each member's products of the blocks' layers, the
    embedders', the head's and the adaLN pass's once (the dequantizing
    GEMM). In w8a8 and w4a8 under ``shard_activations``: K8 once a step
    for each replicated input of the column-split layers (4 a double
    block, 1 a single) and for the 8 unsplit layers, each member's scaled
    GEMM for its column-split layers (8 a double block, 4 a single) and
    for each row-split layer (4 a double block, 1 a single) its row
    absmax, its codes at the row's scale and its int32-out GEMM; the
    adaLN pass's K8 and GEMM once. Over one member the unsharded
    blocks quantize every dense layer's input (K8 and the GEMM each)."""
    joint = 512 + (px // 16) ** 2
    attn = ("flash_chunked" if joint > 8192 else "flash_fwd_pipe"
            if flags == "sp" and members > 1 else "flash_fwd_rope")
    want = dict(NO_LAUNCHES, flash_fwd=24)
    want[attn] = (n2 + n1) * steps * members
    once = 2 * n2 + n1 + 4
    if quantized in ("w8", "w4"):
        want["dequant_gemm"] = ((members * (12 * n2 + 5 * n1) + 8) * steps
                                + once)
    elif quantized in ("w8a8", "w4a8"):
        gemm = "w4a8_gemm" if quantized == "w4a8" else "int8_gemm"
        if members == 1:
            per_step = 12 * n2 + 5 * n1 + 8
            want.update({"quant_rows": per_step * steps + once,
                         gemm: per_step * steps + once})
        else:
            if "tp" not in flags:
                raise ValueError(f"no quantized counts for {flags!r}")
            rows = (4 * n2 + n1) * members * steps
            want.update({
                "quant_rows": (4 * n2 + n1 + 8) * steps + once,
                gemm: ((8 * n2 + 4 * n1) * members + 8) * steps + once,
                f"{gemm}_acc": rows, "row_absmax": rows,
                "quant_rows_at": rows})
    return want


def member_param_bytes(flux) -> tuple:
    """(member 0's DiT parameter and buffer bytes, the whole DiT's) under
    ``shard_activations`` in the one-process form: the whole model less
    the split layers, plus member 0's blocks of them."""
    def size(mod):
        return sum(t.numel() * t.element_size()
                   for t in [*mod.parameters(), *mod.buffers()])

    whole = size(flux)
    member = whole
    for blk in [*flux.double_blocks, *flux.single_blocks]:
        for name, layer in blk.members[0].items():
            member += size(layer) - size(getattr(blk, name))
    return member, whole


def tensor_image(pipe, seed: int, card: str, label: str, flags: str,
                 px: int = 1024, warm: bool = True, control_pixels=None):
    """``label``: one px^2, 4-step image with ``flags`` over
    ``LocalAxis(TP, "tensor")`` against the same flags over one member,
    from the same seed and noise (with ``warm`` each route's image after
    one warm-up image, else its first); exact launch counts of both; the
    s/image of both; under ``shard_activations`` member 0's DiT bytes
    against the whole DiT's. ``control_pixels``: LightControl's guidance
    image, for a pipeline ``with_controls``. The DiT's config and axis are
    set back after. -> {label: launches}."""
    import numpy as np
    import torch
    from x2i_torch.parallel.axis import LocalAxis

    flux, steps = pipe.flux, 4
    req = {"task": "text2image", "prompt": PROMPTS[0]}
    size = dict(height=px, width=px, num_steps=steps)
    if control_pixels is not None:
        size["control_pixels"] = control_pixels
    quantized = flux.cfg.quantized
    out, runs, sec = {}, {}, {}
    bytes_ = None
    flux.replace_config(**TP_FLAGS[flags])
    try:
        for members in (TP, 1):
            flux.set_tensor_axis(LocalAxis(members, "tensor"))
            if members > 1 and flux.cfg.shard_activations:
                bytes_ = member_param_bytes(flux)
            if warm:
                pipe.run_task(**req, seed=seed, **size)
            reset_counts()
            t0 = time.perf_counter()
            out[members] = pipe.run_task(**req, seed=seed, **size)
            sec[members] = time.perf_counter() - t0
            runs[members] = launch_counts()
    finally:
        flux.set_tensor_axis(None)
        flux.replace_config(shard_activations=False, shard_sequence=False)
    a, b = (x.astype(np.float32) for x in (out[TP], out[1]))
    levels = np.abs(a - b)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    want = {m: tensor_launches(flags, m, px, quantized) for m in (TP, 1)}
    heads = flux.cfg.num_attention_heads
    rec = {"phase": "parallel", "check": label, "flags": TP_FLAGS[flags],
           "px": px, "steps": steps, "quantized": quantized,
           "members": TP, "s_per_image": sec[TP],
           "s_per_image_one_member": sec[1],
           "first_call": None if warm else "each image is its route's "
                                           "first (no warm-up)",
           "member_attention": {
               "heads": heads // TP if flags != "sp" else heads,
               "query_rows": (512 + (px // 16) ** 2) // (
                   TP if flags == "sp" else 1)},
           "image_shape": list(out[TP].shape),
           "bit_for_bit": bool(np.array_equal(out[TP], out[1])),
           "max_level_diff": float(levels.max()),
           "mean_level_diff": float(levels.mean()), "rel_l2": rel,
           "rel_l2_bar": TP_IMAGE_REL_L2,
           "launches": runs[TP], "launches_one_member": runs[1],
           "card": card}
    if bytes_ is not None:
        rec["member_dit_bytes"], rec["whole_dit_bytes"] = bytes_
    emit(rec)
    if (runs[TP] != want[TP] or runs[1] != want[1]
            or out[TP].shape != (1, px, px, 3) or rel > TP_IMAGE_REL_L2
            or float(a.std()) == 0.0):
        raise AssertionError(f"{label} is wrong: {rec} (launches expected "
                             f"{want})")
    return {label: runs[TP], f"{label}-1": runs[1]}


# the w8 products of a member of TP at 1024^2 (label, rows, in, out): the
# column-split q/k/v and mlp_in, the row-split attn_out, mlp_out and the
# single block's out, whose parts take no bias
TP_GEMM_SHAPES = (
    ("member q/k/v", 4608, 3072, 3072 // TP),
    ("member single mlp_in", 4608, 3072, 12288 // TP),
    ("member double img attn_out", 4096, 3072 // TP, 3072),
    ("member double img mlp_out", 4096, 12288 // TP, 3072),
    ("member single out", 4608, (3072 + 12288) // TP, 3072))
# the row-split products' text rows besides (w8a8, w4a8: int32 out)
TP_ROW_GEMMS = TP_GEMM_SHAPES[2:] + (
    ("member double txt attn_out", 512, 3072 // TP, 3072),
    ("member double txt mlp_out", 512, 12288 // TP, 3072))
TP_ACC_MAIN = "member double img mlp_out"
# a member's row-split inputs at 1024^2 that K8's halves read (label,
# shape): attention outputs of its 6 heads (image, text and joint rows),
# its FFN block, and the single block's attention + FFN features
TP_ROW_SHAPES = (
    ("member attention, 4608 rows", (1, 4608, 3072 // TP)),
    ("member attention, 4096 rows", (1, 4096, 3072 // TP)),
    ("member attention, 512 rows", (1, 512, 3072 // TP)),
    ("member double img mlp_out, 4096 rows", (1, 4096, 12288 // TP)),
    ("member double txt mlp_out, 512 rows", (1, 512, 12288 // TP)),
    ("member single out, 4608 rows", (1, 4608, (3072 + 12288) // TP)),
    ("tie rows", (1, 256, 3072 // TP)),
    ("tie rows", (64, 12288 // TP)))
TP_ROW_MAIN = "member double img mlp_out, 4096 rows"


def check_row_halves(g, rows, recs):
    """K8's halves at a member's row-split widths (``TP_ROW_SHAPES``): the
    whole row is TP members' blocks, each member's ``row_absmax`` and its
    ``quant_rows_at`` at the members' maximum bit for bit their plain
    versions, each counted once a call, and the members' codes and scale
    together bit for bit whole-row K8 (``quant_rows``); on tie rows too
    (every quotient k + 0.5). Timed at each shape: the absmax against
    ``torch.linalg.vector_norm(ord=inf)`` (``torch.amax`` of |x| in one
    call), the quantization with no one PyTorch call beside it."""
    import torch
    from x2i_torch.ops import fused_glue as fg

    for label, shape in TP_ROW_SHAPES:
        whole_shape = (*shape[:-1], shape[-1] * TP)
        if label == "tie rows":
            whole = tie_rows(g, math.prod(shape[:-1]), whole_shape[-1]) \
                .view(whole_shape)
        else:
            whole = rows(*whole_shape)
        parts = [t.contiguous() for t in whole.split(shape[-1], -1)]
        before = dict(fg.LAUNCHES)
        amaxes = [fg.row_absmax(x) for x in parts]
        amax = amaxes[0]
        for a in amaxes[1:]:
            amax = torch.maximum(amax, a)
        quants = [fg.quant_rows_at(x, amax) for x in parts]
        counted = fg.LAUNCHES == dict(
            before, row_absmax=before["row_absmax"] + TP,
            quant_rows_at=before["quant_rows_at"] + TP)
        q_whole, a_whole = fg.quant_rows(whole)
        plain_amax = [fg.row_absmax_plain(x) for x in parts]
        plain_q = [fg.quant_rows_at_plain(x, amax) for x in parts]
        torch.cuda.synchronize()
        ok_amax = all(torch.equal(a, b) for a, b in zip(amaxes, plain_amax))
        ok_q = all(torch.equal(q, qp) and torch.equal(a, ap)
                   for (q, a), (qp, ap) in zip(quants, plain_q))
        ok_whole = (torch.equal(torch.cat([q for q, _ in quants], -1),
                                q_whole)
                    and all(torch.equal(a, a_whole) for _, a in quants))
        x = parts[0]
        q0, a0 = quants[0]
        for name in ("row_absmax", "quant_rows_at"):
            if name == "row_absmax":
                fn, plain = fg.row_absmax, fg.row_absmax_plain
                inputs, outs = (x,), (amaxes[0],)
                lib = (lambda t: torch.linalg.vector_norm(
                    t, float("inf"), -1, keepdim=True, dtype=torch.float32))
                ops = 2
                err = (amaxes[0] - plain_amax[0]).abs().max().item()
            else:
                fn, plain = fg.quant_rows_at, fg.quant_rows_at_plain
                inputs, outs = (x, amax), (q0, a0)
                lib = None
                ops = 5
                err = (q0.float() * a0 - plain_q[0][0].float()
                       * plain_q[0][1]).abs().max().item()
            rec = {"phase": "parallel", "check": "tensor-kernels",
                   "kernel": name, "case": label, "shape": list(shape),
                   "members": TP, "max_abs_err": err,
                   "bit_for_bit": ok_amax if name == "row_absmax" else ok_q,
                   "whole_row_k8_bits": ok_whole, "counted_once": counted,
                   "ms": kernel_ms(fn, *inputs),
                   "plain_ms": kernel_ms(plain, *inputs),
                   "library_ms": None if lib is None else kernel_ms(lib, x),
                   "library": ("torch.linalg.vector_norm(ord=inf), f32 out"
                               if lib else "none: no one PyTorch call "
                               "computes a per-row int8 quantization at a "
                               "given absmax")}
            rec["bound_ms"], rec["bound_by"] = bound(
                ops * x.numel(), nbytes(*inputs, *outs), PEAK_F32_FLOPS)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            recs.setdefault(name, []).append(rec)
        if not (ok_amax and ok_q and ok_whole and counted):
            raise AssertionError(f"K8's halves disagree at {label} "
                                 f"{shape}: absmax {ok_amax}, codes "
                                 f"{ok_q}, whole row {ok_whole}, counted "
                                 f"{counted}")


def check_acc_gemms(g, rows, recs):
    """The int8 and w4a8 GEMMs' int32-out instances at a member's
    row-split products (``TP_ROW_GEMMS``; w4a8 on a weight quantized at
    the member's own width, groups of 128, as a member's shard is packed):
    exact against their plain versions, each counted once a call, timed
    beside the scaled instance of the same product (``scaled_ms``) and, for
    int8, ``torch._int_mm`` (the same int32 product). At the column-split
    shapes the scaled instances against their plain versions (int8 within
    one bf16 step, w4a8 bit for bit)."""
    import torch
    from x2i_torch.ops import fused_glue as fg
    from x2i_torch.ops import int4_gemm as i4
    from x2i_torch.ops import int8_gemm as ig
    from x2i_torch.ops.quant import quantize_kernel, quantize_kernel_w4a8

    dev = torch.device("cuda")
    columns = [s for s in TP_GEMM_SHAPES if s not in TP_ROW_GEMMS]
    for mode in ("int8", "w4a8"):
        for label, m, k, n in TP_ROW_GEMMS + tuple(columns):
            wf = torch.randn((n, k), generator=g, device=dev) / k ** 0.5
            if mode == "int8":
                q, scale = quantize_kernel(wf.t())
                w = (q.t().contiguous(),)
                acc_fn, acc_plain = ig.int8_matmul_acc, ig.int8_matmul_acc_plain
                lin, lin_plain = ig.int8_linear, ig.int8_linear_plain
            else:
                pk, ms, scale = quantize_kernel_w4a8(wf.t())
                w = (pk.t().contiguous(), ms)
                acc_fn, acc_plain = i4.w4a8_matmul_acc, \
                    i4.w4a8_matmul_acc_plain
                lin, lin_plain = i4.w4a8_linear, i4.w4a8_linear_plain
            del wf
            xq, a = fg.quant_rows_plain(rows(m, k))

            def scaled(x, s, *ws):
                return lin(x, s, *ws, scale)

            def scaled_plain(x, s, *ws):
                return lin_plain(x, s, *ws, scale)

            got, want = scaled(xq, a, *w), scaled_plain(xq, a, *w)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            scaled_ok = (torch.equal(got, want) if mode == "w4a8" else
                         bool((diff <= 2.0 ** -7 * want.float().abs()).all()))
            name = f"{mode}_gemm"
            rec = {"phase": "parallel", "check": "tensor-kernels",
                   "case": label, "shape": [m, k, n],
                   "scaled_within_bar": scaled_ok,
                   "scaled_max_abs_err": diff.max().item()}
            if (label, m, k, n) in TP_ROW_GEMMS:
                before = dict(ig.GEMM.launches)
                acc = acc_fn(xq, *w)
                counted = ig.GEMM.launches == dict(
                    before, **{f"{name}_acc": before[f"{name}_acc"] + 1})
                exact = torch.equal(acc, acc_plain(xq, *w))
                rec.update(kernel=f"{name}_acc", acc_exact=exact,
                           counted_once=counted, max_abs_err=0.0 if exact
                           else float("inf"),
                           ms=kernel_ms(acc_fn, xq, *w),
                           plain_ms=kernel_ms(acc_plain, xq, *w),
                           scaled_ms=kernel_ms(scaled, xq, a, *w))
                if mode == "int8":
                    rec.update(library_ms=kernel_ms(
                        torch._int_mm, xq, w[0].t()),
                        library="torch._int_mm")
                else:
                    rec.update(library_ms=None, library="none: no one "
                               "PyTorch call computes it from the codes")
                out_bytes = m * n * 4
                ok = exact and counted and scaled_ok
            else:
                rec.update(kernel=name, max_abs_err=diff.max().item(),
                           ms=kernel_ms(scaled, xq, a, *w),
                           plain_ms=kernel_ms(scaled_plain, xq, a, *w),
                           library_ms=None, library="see the main shapes")
                out_bytes = nbytes(got, a, scale)
                ok = scaled_ok
            weight_bytes = (n * k if mode == "int8" else
                            n * k // 2 + w[1].numel())
            rec["bound_ms"], rec["bound_by"] = bound(
                2.0 * m * n * k, nbytes(xq) + weight_bytes + out_bytes,
                PEAK_INT8_OPS)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            recs.setdefault(rec["kernel"], []).append(rec)
            if not ok:
                raise AssertionError(f"{rec['kernel']} disagrees with its "
                                     f"plain version: {rec}")


def check_tensor_kernels(g, recs):
    """``tensor-kernels``: the kernels at a member's shapes, against their
    plain versions (``check_flash``, ``check_dequant_gemms``): K1a on 6 of
    24 heads at 4608 tokens with the rope (the qk norm outside under the
    flags), K1c on a member's 1152 query rows against the 4608 gathered
    keys, K2 on 6 heads at 16,896 tokens; the w8 and w4 dequantizing GEMM
    at the member's widths, the row-split parts without their bias; K8's
    halves (``check_row_halves``) and the int32-out GEMMs with the scaled
    ones at the member's products (``check_acc_gemms``)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    def sdpa(*t):
        return F.scaled_dot_product_attention(*t)

    def check(name, case, q, k, v, **kw):
        rows = []
        lib = (sdpa, [t.transpose(1, 2).contiguous() for t in (q, k, v)])
        check_flash(name, q, k, v, rows, library=lib, **kw)
        for r in rows:
            r.update(case=case, phase="parallel", check="tensor-kernels")
            recs.setdefault(name, []).append(r)

    heads = RING_HEADS // TP
    s = 512 + (1024 // 16) ** 2
    rope = _rope_tables(512, 128, (16, 56, 56), dev)
    check("flash_fwd_rope", "member of 4: 6 heads, rope, norm outside",
          randn(1, s, heads, RING_D), randn(1, s, heads, RING_D),
          randn(1, s, heads, RING_D), rope=rope)
    check("flash_fwd_pipe", "member of 4: 1152 query rows of 4608 keys",
          randn(1, s // TP, RING_HEADS, RING_D),
          randn(1, s, RING_HEADS, RING_D), randn(1, s, RING_HEADS, RING_D))
    s = 512 + (2048 // 16) ** 2
    q, k, v = (randn(1, s, heads, RING_D) for _ in range(3))
    lib = (sdpa, [t.transpose(1, 2).contiguous() for t in (q, k, v)])
    chunked = {}
    check_flash_chunked("member of 4: 6 heads at 16,896 tokens",
                        *(t.transpose(1, 2) for t in (q, k, v)), chunked,
                        lib, 2048)
    for r in chunked["flash_chunked"]:
        r.update(case=r["kernel"], phase="parallel", check="tensor-kernels")
        recs.setdefault("flash_chunked", []).append(r)
    del q, k, v, lib
    torch.cuda.empty_cache()

    def rows(*shape):
        lead = (*shape[:-1], 1)
        sigma = 10.0 ** torch.empty(lead, device=dev).uniform_(
            -2.0, 2.0, generator=g)
        mu = sigma * 3.0 * torch.randn(lead, generator=g, device=dev)
        return (torch.randn(shape, generator=g, device=dev) * sigma + mu
                ).to(torch.bfloat16)

    gemm = []
    check_dequant_gemms(g, rows, {"dequant_gemm": gemm},
                        shapes=TP_GEMM_SHAPES,
                        modes=(("w8", None), ("w4", 128)),
                        timed=("member single out",), biased=False)
    for r in gemm:
        r.update(phase="parallel", check="tensor-kernels")
        recs.setdefault("dequant_gemm", []).append(r)
    check_row_halves(g, rows, recs)
    check_acc_gemms(g, rows, recs)


def phase_tensor(pipe, seed: int, card: str, recs: dict) -> dict:
    """The tensor-parallel group: tensor-kernels, then on the bf16 serving
    DiT tp-image, sp-image and tp+sp-image at 1024^2 and tp-2048 (its
    images each its route's first). -> {run label: launches}."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + 220)
    check_tensor_kernels(g, recs)
    runs = {}
    for flags in TP_FLAGS:
        runs.update(tensor_image(pipe, seed, card, f"{flags}-image", flags))
    runs.update(tensor_image(pipe, seed, card, "tp-2048", "tp", px=2048,
                             warm=False))
    torch.cuda.empty_cache()
    return runs


def phase_parallel(pipe, seed: int, card: str, t_train: float):
    """The parallel phase's checks after the training ones
    (``parallel_training``, ``t_train`` s): ring-kernels, ring-image,
    pipeline-forward, mesh serving and the tensor-parallel group; then
    the phase's summary with its seconds. -> (kernel records, {run label:
    launches})."""
    import torch
    t0 = time.perf_counter()
    recs = {}
    g = torch.Generator(device="cuda").manual_seed(seed + 190)
    runs = check_ring_kernels(g, recs)
    runs.update(ring_image(pipe, seed, card))
    runs.update(pipeline_forward(pipe, seed, card))
    mesh_serving(pipe, seed)
    t1 = time.perf_counter()
    runs.update(phase_tensor(pipe, seed, card, recs))
    emit({"phase": "parallel-summary", "seconds": time.perf_counter() - t0
          + t_train, "training_s": t_train,
          "tensor_s": time.perf_counter() - t1, "card": card})
    return recs, runs


# the kernels line: (name, route, source, TPU kernel it replaces, main path
# whose launches it reports -- one image, one 32k-token encode, or one
# timed training step --, the record whose times it reports)
KERNEL_TABLE = (
    ("flash_fwd_rope", "cuda", FLASH_SRC, f"{TPU_FLASH}:90", "bf16", 0),
    ("flash_fwd", "cuda", FLASH_SRC, f"{TPU_FLASH}:199", "bf16", 0),
    ("flash_fwd_f32", "cuda", FLASH_SRC, f"{TPU_FLASH}:199", "eval", 0),
    ("ln_mod", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:84", "bf16", 2),
    ("ln_mod_quant", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:62", "w8a8", 2),
    ("gelu_quant", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:70", "w8a8", -1),
    ("quant_rows", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:78", "w8a8",
     "attention, 4608 rows"),
    ("int8_gemm", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:94", "w8a8",
     GEMM_MAIN),
    ("flash_chunked", "cuda", FLASH_CHUNKED_SRC, f"{TPU_FLASH}:368",
     "bf16-2048", 0),
    ("flash_fwd_pipe", "cuda", FLASH_SRC, f"{TPU_FLASH}:160", "distill", 0),
    ("flash_fwd_lse", "cuda", FLASH_SRC, f"{TPU_FLASH}:220", "distill", 0),
    ("flash_bwd_dq", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:526", "distill",
     0),
    ("flash_bwd_dkv", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:581", "distill",
     0),
    ("w4a8_gemm", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:281", "w4a8",
     GEMM_MAIN),
    ("dequant_gemm", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:163", "w4",
     DEQUANT_GEMM_MAIN),
    ("w4_dequant", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:153",
     "lightcontrol-train-w4", DEQUANT_MAIN),
    ("int8_dequant", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:77",
     "train-resume", DEQUANT_MAIN),
    ("w4a8_dequant", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:359",
     "lightcontrol-train-w4a8", DEQUANT_MAIN),
    ("row_absmax", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:78", "tp-w8a8",
     TP_ROW_MAIN),
    ("quant_rows_at", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:78", "tp-w8a8",
     TP_ROW_MAIN),
    ("int8_gemm_acc", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:43",
     "tp-w8a8", TP_ACC_MAIN),
    ("w4a8_gemm_acc", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:281",
     "tp-w4a8", TP_ACC_MAIN),
    ("flash_fwd_lse_f32", "cuda", FLASH_SRC, f"{TPU_FLASH}:220",
     "lightcontrol-train-f32", 0),
    ("flash_chunked_f32", "cuda", FLASH_CHUNKED_SRC, f"{TPU_FLASH}:368",
     "f32-2048", 0),
    ("flash_bwd_dq_f32", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:526",
     "lightcontrol-train-f32", 0),
    ("flash_bwd_dkv_f32", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:581",
     "lightcontrol-train-f32", 0),
    ("flash_fwd_rope_d256", "cuda", FLASH_SRC, f"{TPU_FLASH}:90", "d256", 0),
    ("flash_chunked_d256", "cuda", FLASH_CHUNKED_SRC, f"{TPU_FLASH}:368",
     "d256-2048", 0),
    ("flash_fwd_rope_f32", "cuda", FLASH_SRC, f"{TPU_FLASH}:90", "f32-fused",
     0),
    ("ln_mod_f32", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:84", "f32-fused", 2),
    ("flash_fwd_lse_d256", "cuda", FLASH_SRC, f"{TPU_FLASH}:220",
     "d256-train", 0),
    ("flash_bwd_dq_d256", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:526",
     "d256-train", 0),
    ("flash_bwd_dkv_d256", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:581",
     "d256-train", 0),
    ("flash_fwd_lse_f32_d256", "cuda", FLASH_SRC, f"{TPU_FLASH}:220",
     "lightcontrol-train-f32-d256", 0),
    ("flash_bwd_dq_f32_d256", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:526",
     "lightcontrol-train-f32-d256", 0),
    ("flash_bwd_dkv_f32_d256", "cuda", FLASH_BWD_SRC, f"{TPU_FLASH}:581",
     "lightcontrol-train-f32-d256", 0),
    ("ln_mod_quant_f32", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:62", "f32-w8a8",
     F32_GLUE_MAIN["ln_mod_quant"]),
    ("gelu_quant_f32", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:70", "f32-w8a8",
     F32_GLUE_MAIN["gelu_quant"]),
    ("quant_rows_f32", "cuda", ROW_GLUE_SRC, f"{TPU_GLUE}:78", "f32-w8a8",
     F32_GLUE_MAIN["quant_rows"]),
    ("int8_gemm_f32", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:94",
     "f32-w8a8", GEMM_MAIN),
    ("w4a8_gemm_f32", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:281",
     "f32-w4a8", GEMM_MAIN),
    ("int8_dequant_f32", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:102",
     "f32-w8-reference", DEQUANT_MAIN),
    ("w4_dequant_f32", "cuda", GEMM_SRC, "x2i_tpu/ops/quant.py:153",
     "f32-w4-reference", DEQUANT_MAIN),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build and kernels phases, before "
                         "any model is built: to measure a kernel after an "
                         "edit; prints no final ok line")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs one",
              file=sys.stderr)
        return 2
    import x2i_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase_build()
    recs = phase_kernels(args.seed)
    if args.kernels_only:
        print(smi, flush=True)
        emit({"kernels_only": True,
              "kind": torch.cuda.get_device_name(0)})
        return 0
    launches_ckpt = phase_checkpoint(args.seed, smi)
    pipe, lm, launches, bf16_pixels, dit_state = phase_text2image(args.seed)
    launches_inter = phase_interleaved(pipe, bf16_pixels, args.seed, smi)
    launches_proj = phase_proj_variants(pipe, args.seed, smi)
    phase_serve(pipe)
    launches_image = phase_image(pipe, lm, args.seed, smi)
    launches_2048, pixels_2048 = phase_text2image_2048(pipe, args.seed)
    launches_long = phase_long_prompt(pipe, lm, args.seed)
    launches_d256, d256_images = phase_d256(pipe, args.seed, smi)
    launches_d256.update(phase_d256_train(pipe, args.seed, smi))
    launches_d256.update(phase_d256_ring(pipe, d256_images, args.seed, smi))
    del d256_images
    launches_f32 = phase_f32(pipe, pixels_2048, args.seed, smi)
    del pixels_2048
    train_s = []

    def parallel_train(*trainer):
        t0 = time.perf_counter()
        state = parallel_training(*trainer, args.seed, smi)
        train_s.append(time.perf_counter() - t0)
        return state

    launches_distill, _ = phase_distill(pipe, lm, args.seed, smi,
                                        after=parallel_train)
    par_recs, launches_parallel = phase_parallel(pipe, args.seed, smi,
                                                 train_s[0])
    for name, rows in par_recs.items():
        recs.setdefault(name, []).extend(rows)
    launches_data, _ = phase_data_train(pipe, lm, args.seed, smi)
    launches_eval = phase_eval(pipe, args.seed, smi)
    launches_lc, control = phase_lightcontrol(pipe, bf16_pixels, args.seed,
                                              smi)
    # the controlled image under both flags over the tensor axis
    launches_tp_lc = tensor_image(pipe.with_controls(*control[:2]),
                                  args.seed, smi, "tp+sp-control", "tp+sp",
                                  control_pixels=control[2])
    launches_lc_train, _ = phase_lightcontrol_train(pipe, lm, args.seed, smi)
    launches_resume, quantize_s, launches_lc_train_w8a8 = phase_train_resume(
        pipe, lm, args.seed, smi)
    launches_w8a8, launches_lc_w8a8, launches_f32_quant = phase_w8a8(
        pipe, bf16_pixels, args.seed, control, quantize_s, smi)
    del control
    launches_tp_quant = tensor_image(pipe, args.seed, smi, "tp-w8a8", "tp")
    launches_w4a8, more = phase_quant(pipe, bf16_pixels, args.seed,
                                      dit_state, "w4a8", smi)
    launches_f32_quant.update(more)
    launches_tp_quant.update(tensor_image(pipe, args.seed, smi, "tp-w4a8",
                                          "tp"))
    launches_lc_train_w4a8 = phase_lightcontrol_steps(
        pipe, args.seed, smi, "lightcontrol-train-w4a8",
        LIGHTCONTROL_W4A8_LAUNCHES, steps=2, use_8bit_adam=True)
    launches_w4, more = phase_quant(pipe, bf16_pixels, args.seed, dit_state,
                                    "w4", smi)
    launches_f32_quant.update(more)
    launches_tp_quant.update(tensor_image(pipe, args.seed, smi, "tp-w4",
                                          "tp"))
    launches_lc_train_w4 = phase_lightcontrol_steps(
        pipe, args.seed, smi, "lightcontrol-train-w4",
        LIGHTCONTROL_W4_LAUNCHES, steps=2, use_8bit_adam=True)
    launches_w8, more = phase_quant(pipe, bf16_pixels, args.seed, dit_state,
                                    "w8", smi)
    launches_f32_quant.update(more)
    launches_tp_w8 = tensor_image(pipe, args.seed, smi, "tp-w8", "tp")
    launches_registry = phase_registry(pipe, args.seed, dit_state, smi)
    runs = {"bf16": launches, "image": launches_image,
            "w8a8": launches_w8a8, "w4a8": launches_w4a8,
            "w4": launches_w4, "w8": launches_w8,
            "distill": launches_distill, "bf16-2048": launches_2048,
            "data-train": launches_data, "eval": launches_eval,
            "lightcontrol": launches_lc,
            "lightcontrol-w8a8": launches_lc_w8a8,
            "lightcontrol-train": launches_lc_train,
            "train-resume": launches_resume,
            "lightcontrol-train-w8a8": launches_lc_train_w8a8,
            "lightcontrol-train-w4a8": launches_lc_train_w4a8,
            "lightcontrol-train-w4": launches_lc_train_w4,
            "long-prompt": launches_long, "interleaved": launches_inter,
            **launches_f32, **launches_f32_quant, **launches_d256,
            **launches_proj, **launches_ckpt, **launches_tp_w8,
            **launches_tp_quant, **launches_tp_lc,
            **launches_registry, **launches_parallel}

    table = []
    for name, route, source, replaces, run, main in KERNEL_TABLE:
        rows = recs[name]
        top = rows[main] if isinstance(main, int) else next(
            r for r in rows if r.get("case") == main)
        table.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": runs[run][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "shape": top["shape"],
            "main_path": run})
        for extra in ("library", "tflops", "tops", "bound_share",
                      "call_ms", "int8_gemm_ms", "linear_ms",
                      "dequant_linear_ms", "blocks_per_sm", "waves"):
            if top.get(extra) is not None:
                table[-1][extra] = top[extra]
        # the kernel's other shapes on the main paths (K1b at the ViT's)
        cases = [{k: r.get(k) for k in (
            "case", "shape", "kv_shape", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "tflops", "bound_share",
            "call_ms")} | {k: r[k] for k in ("library_padded_ms",
                                              "blocks_per_sm", "waves")
                           if k in r}
            for r in rows if r.get("case")]
        if cases:
            table[-1]["cases"] = cases
        # a kernel's launches on the other main paths that run it
        others = {r: runs[r][name] for r in runs
                  if r != run and runs[r].get(name)}
        if others:
            table[-1]["launches_on_other_paths"] = others
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
