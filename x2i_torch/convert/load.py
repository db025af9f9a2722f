"""Checkpoints into the port: safetensors and torch files -> an assembled
``X2IPipeline``, the counterpart of ``x2i_tpu/convert/load.py``: the
InternVL2.5 and Qwen2.5-VL encoders with their vision towers, and
MiniCPM-o's omni encoder (SigLIP, the resampler, Whisper and its
projector) and its speech modules (``load_tts``); and LightControl's
ControlNeXt bank (``load_control_bank``).

The artifacts are those the reference reads: a diffusers FLUX directory
(``transformer/*.safetensors``, one file or ``-0000k-of-0000n`` shards,
``vae/*.safetensors``, their ``config.json`` files and
``scheduler/scheduler_config.json``); an HF MLLM directory of the
InternVL2.5, Qwen2.5-VL or MiniCPM-o family (``config.json``,
``*.safetensors``, the tokenizer's files); and the proj's
``diffusion_pytorch_model.bin`` with optional DDP ``module.`` prefixes.

The safetensors reader needs no package: it reads the format's 8-byte
little-endian header length, its JSON header (dtype, shape and data
offsets of each tensor, and ``__metadata__``) and maps the raw
little-endian bytes of each tensor in turn, yielding the tensor as a view
of its mapping. The converters (``torch_models.fill_module``) copy each
view into its module on the card and move on; the mapping goes with the
view, so the host maps no more than a tensor of a checkpoint at a time.

The tokenizer is an argument: the machine with the card has no
``transformers``, which is imported only when the caller passes none, and
then only by ``load_tokenizer``, the one loader of every tokenizer of the
port (the MLLM's here, the teachers' in ``train/assemble.py``, the CLIP
scorer's in ``evalmetrics.py``).
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import sys
import warnings
from dataclasses import replace
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from torch import nn

from x2i_torch.convert.hf_config import (clip_configs_from_dir,
                                         flux_config_from_dir,
                                         internvl_config_from_dir,
                                         minicpm_scale_resolution,
                                         minicpmo_config_from_dir,
                                         proj_config_from_sd,
                                         qwenvl_config_from_dir,
                                         scheduler_config_from_dir,
                                         t5_config_from_dir,
                                         vae_config_from_dir)
from x2i_torch.convert.torch_models import (chattts_off_path,
                                            chattts_plan, clip_off_path,
                                            clip_plan, clip_text_plan,
                                            controlnext_plan,
                                            dvae_plan, dvae_quantizer_in,
                                            fill_module, flux_plan,
                                            internlm2_plan, internvl_plan,
                                            minicpmo_off_path,
                                            minicpmo_plan, proj_plan,
                                            qwen2_5_vl_plan, t5_off_path,
                                            t5_plan, vae_plan)
from x2i_torch.core.config import (MODEL_REGISTRY, ControlNeXtConfig,
                                   GenerationConfig, InternVLConfig,
                                   MiniCPMOConfig, quant_mode, with_dtype)
from x2i_torch.data.minicpm_vision import (audio_placeholder_spans,
                                           bounds_to_map, chunk_audio_mels,
                                           prepare_minicpm_vision)
from x2i_torch.data.qwen_vision import (concat_vision_inputs,
                                        get_rope_index,
                                        prepare_vision_inputs)
from x2i_torch.data.vision import image_tiles
from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
from x2i_torch.models.chattts import DVAE, ChatTTSConfig, ConditionalChatTTS
from x2i_torch.models.clip import CLIPModel, CLIPTextEncoder
from x2i_torch.models.controlnext import ControlBank
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.internvl import InternVLEncoder
from x2i_torch.models.minicpmo import (MiniCPMOEncoder, audio_tensors,
                                       slice_tensors)
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.qwen2_5_vl import (Qwen2_5_VLConfig,
                                         Qwen2_5_VLEncoder,
                                         QwenVisionConfig, encode_text,
                                         encode_with_answer,
                                         vision_tensors)
from x2i_torch.models.t5 import T5Encoder
from x2i_torch.models.templates import (IMAGE_PREFIX, expand_image_tokens,
                                        internvl2_5_prompt,
                                        minicpm_omni_content,
                                        qwen_chat_messages,
                                        task_instruction)
from x2i_torch.models.vae import AutoencoderKL
from x2i_torch.ops.quant import quantize_module_
from x2i_torch.pipeline import X2IPipeline, lm_encoder, resolve_device

# the safetensors dtypes the reader takes
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "F64": torch.float64, "I8": torch.int8,
          "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
          "I64": torch.int64, "BOOL": torch.bool}
SEQ = 512                     # the padded prompt length
ANSWER_TOKENS = 128           # use_answer's decode budget (the reference's)


def read_header(path: str) -> Tuple[int, Dict[str, Dict[str, Any]]]:
    """-> (the byte offset of the data, {name: {"dtype", "shape",
    "data_offsets"}} in the order of the data). Raises ValueError on a
    dtype the reader does not take, on offsets that disagree with a
    tensor's size, and on a file shorter than its header says."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated (no header length)")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: truncated header ({n} bytes "
                             f"announced, {size - 8} in the file)")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data_start, data_size = 8 + n, size - 8 - n
    for name, e in header.items():
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {e['dtype']}, not "
                             f"one of {sorted(DTYPES)}")
        begin, end = e["data_offsets"]
        want = (int(np.prod(e["shape"], dtype=np.int64))
                * DTYPES[e["dtype"]].itemsize)
        if end - begin != want or begin < 0:
            raise ValueError(f"{path}: {name} spans {end - begin} bytes, "
                             f"its shape needs {want}")
        if end > data_size:
            raise ValueError(f"{path}: truncated ({name} ends at byte "
                             f"{end} of {data_size})")
    return data_start, dict(sorted(header.items(),
                                   key=lambda kv: kv[1]["data_offsets"][0]))


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) for every tensor of a safetensors file, in
    the order of its data. Each tensor is a CPU view of a read-only
    mapping of its own bytes, unmapped when the caller drops the view:
    read it (copy it where it is to live) and let it go before the next
    one, so that one tensor of the file is mapped at a time."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors data is little-endian")
    data_start, header = read_header(path)
    gran = mmap.ALLOCATIONGRANULARITY
    with open(path, "rb") as f:
        for name, e in header.items():
            dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
            begin, end = (data_start + o for o in e["data_offsets"])
            if end == begin:
                yield name, torch.empty(shape, dtype=dtype)
                continue
            # bool as bytes; an offset off the dtype's alignment is copied
            read = torch.uint8 if dtype == torch.bool else dtype
            if begin % read.itemsize:
                f.seek(begin)
                t = torch.frombuffer(bytearray(f.read(end - begin)),
                                     dtype=read)
            else:
                start = begin // gran * gran
                mm = mmap.mmap(f.fileno(), end - start, offset=start,
                               access=mmap.ACCESS_READ)
                with warnings.catch_warnings():
                    # the view is read-only, and never written
                    warnings.simplefilter("ignore", UserWarning)
                    t = torch.frombuffer(mm, dtype=read,
                                         offset=begin - start,
                                         count=(end - begin) // read.itemsize)
                del mm                   # the view holds the mapping
            yield name, t.view(dtype).reshape(shape)
            del t


def safetensors_files(path: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors in {path}")
    return files


def load_safetensors_dir(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every tensor of every ``*.safetensors`` under ``path``, the files
    in sorted order (a sharded checkpoint's shards in turn), lazily as
    ``read_safetensors`` yields them."""
    for f in safetensors_files(path):
        yield from read_safetensors(f)


def safetensors_keys(path: str) -> List[str]:
    """The tensor names of a safetensors directory, from the headers
    alone."""
    return [k for f in safetensors_files(path) for k in read_header(f)[1]]


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_control_bank(path: str, cfg: Optional[ControlNeXtConfig] = None,
                      device=None, num_controls: int = 19) -> ControlBank:
    """LightControl's trained branches -> a ``ControlBank`` on ``device``
    (CUDA unless named), for ``X2IPipeline.with_controls``. ``path``: the
    reference's bank state dict (``{i}.time_embedding.linear_1.weight``
    ...) as a safetensors file, a directory of them, or a torch ``.bin``
    (read with ``weights_only=True``). Raises on a key the plan does not
    read and on a parameter no key fills (``fill_module``); the bank's
    load report is ``bank.load_report``."""
    cfg = cfg or ControlNeXtConfig()
    dev = resolve_device(device)
    if os.path.isdir(path):
        tensors = load_safetensors_dir(path)
    elif path.endswith(".safetensors"):
        tensors = read_safetensors(path)
    else:
        tensors = load_torch_bin(path).items()
    bank = ControlBank(cfg, num_controls, device="meta").to_empty(device=dev)
    bank.load_report = fill_module(bank, tensors,
                                   controlnext_plan(cfg, num_controls))
    return bank


def load_tts(path: str, cfg: Optional[ChatTTSConfig] = None, device=None
             ) -> Tuple[ConditionalChatTTS, DVAE]:
    """MiniCPM-o's speech modules from its checkpoint directory (the
    MLLM's, whose encoder load leaves them unread): the ``tts.`` keys into
    a ``ConditionalChatTTS`` of ``cfg`` (``ChatTTSConfig()`` by default)
    and the ``tts.dvae.`` keys into a ``DVAE`` (without its quantizer
    where the directory has no ``vq_layer``), on ``device`` (CUDA unless
    named), in the config's dtype. Raises on a ``tts.`` key neither plan
    reads, ``chattts_off_path`` apart, and on a parameter no key fills;
    each module's report is its ``load_report``. The vocoder is not in
    the directory (JAX has no converter for it)."""
    cfg = cfg or ChatTTSConfig()
    dev = resolve_device(device)
    keys = safetensors_keys(path)

    def tensors(speech):
        return ((k, t) for k, t in load_safetensors_dir(path) if speech(k))

    tts = ConditionalChatTTS(cfg, device="meta").to_empty(device=dev)
    tts.load_report = fill_module(
        tts, tensors(lambda k: k.startswith("tts.")
                     and not k.startswith("tts.dvae.")),
        chattts_plan(cfg, keys), chattts_off_path())
    quantizer = dvae_quantizer_in(keys)
    dvae = DVAE(cfg.dtype, device="meta", quantizer=quantizer).to_empty(
        device=dev)
    dvae.load_report = fill_module(
        dvae, tensors(lambda k: k.startswith("tts.dvae.")),
        dvae_plan(quantizer))
    return tts, dvae


# ------------------------------------------------------------ encoders

def mllm_encoder(model: str, lm: Qwen2LM, tokenizer, vl_cfg=None,
                 vision: Optional[nn.Module] = None,
                 scale_resolution: int = 448):
    """The encoder of ``model``'s family over ``lm``: encoder_fn (inputs)
    -> the hidden-state stack, with ``.batch`` (one 512-token prefill,
    and one vision call, for a list of requests) and ``.ctx`` (the LM,
    ``vision``, the tokenizer and the EOS id, for callers that drive the
    LM or time the tower). Every prompt is padded to 512 tokens on the
    tokenizer's own padding side.

    * InternVL2.5 (``vl_cfg`` an ``InternVLConfig``, by default the
      registry's; ``vision`` the ``InternVLEncoder`` over ``lm``): the
      task instruction in the internvl2_5 template, after ``<image>`` and
      a newline when there are images, whose tiles (``data/vision.py``, one 448
      tile each at X2I's 128^2) expand it to ``num_image_token``
      ``<IMG_CONTEXT>`` tokens a tile; the ViT's features fill them.
      ``video`` and ``audio`` are ignored, as in JAX;
    * Qwen2.5-VL (``vl_cfg`` a ``Qwen2_5_VLConfig``; ``vision`` the
      ``QwenVisionTransformer``): the chat messages through the
      tokenizer's chat template, each ``<|image_pad|>`` and
      ``<|video_pad|>`` expanded to its medium's merged-token count
      (``data/qwen_vision.py``: images and video frames at 128^2), 3-D
      positions from ``get_rope_index`` (padded positions at 1), the
      tower's features at the pad positions, the LM under the M-RoPE
      tables; ``audio`` is ignored, as in JAX;
    * MiniCPM-o (``vl_cfg`` a ``MiniCPMOConfig``, by default one over
      ``lm``'s config; ``vision`` the ``MiniCPMOEncoder`` over ``lm``):
      the omni content (a placeholder per image and video frame, one for
      the audio, the raw prompt) as one user turn of the chat template,
      each image's placeholder expanded to ``query_num`` ``<unk>`` and
      the audio's to one ``<audio>...</audio>`` run of ``<unk>`` a second
      (``chunk_input``); one slice an image at ``scale_resolution``
      (the directory's ``preprocessor_config.json``), the audio's log-mel
      in 30 s chunks; the ``<unk>`` runs give the scatter maps, images
      first, then audio. One SigLIP + resampler call for every slice of
      the batch and one Whisper call for every mel chunk.

    Images are PIL images, or the host half's output: an InternVL
    image's (T, 448, 448, 3) float32 tiles, a Qwen2.5-VL image's or
    video's pair (flat patches, grid_thw), a MiniCPM-o image's pair
    (patches, (h, w)). Audio is a 16 kHz float waveform. Without
    ``vision`` a request with media raises ValueError.

    ``use_answer`` (reasoning2image) is Qwen2.5-VL's: a greedy answer of
    128 tokens after the prompt (its media included), ending at the
    tokenizer's EOS (151645 where it has none), and the stack of prompt
    and answer; the other two families raise ValueError, as in JAX."""
    if not any(f in model for f in ("internvl", "qwenvl", "minicpm")):
        raise ValueError(f"unknown model family for {model}")
    dev = lm.embed_tokens.weight.device
    eos = tokenizer.eos_token_id or 151645

    def tokenize(text):
        enc = tokenizer(text, padding="max_length", max_length=SEQ,
                        truncation=True)
        return (np.asarray(enc["input_ids"], np.int64),
                np.asarray(enc["attention_mask"], bool))

    def no_vision():
        raise ValueError(f"{model}: this encoder was built without its "
                         f"media towers; it takes no images, video or "
                         f"audio")

    def no_answer(*_):
        family = "internvl" if "internvl" in model else "minicpm"
        raise ValueError(f"use_answer is a Qwen2.5-VL feature; the "
                         f"{family} family has no answer-conditioned mode")

    if "internvl" in model:
        encoder_fn, batch_fn = _internvl(lm, tokenize, vl_cfg, vision, dev,
                                         no_vision, no_answer)
    elif "qwenvl" in model:
        encoder_fn, batch_fn = _qwenvl(lm, tokenizer, tokenize, vl_cfg,
                                       vision, dev, eos, no_vision)
    else:
        encoder_fn, batch_fn = _minicpm(lm, tokenizer, tokenize, vl_cfg,
                                        vision, dev, no_vision, no_answer,
                                        scale_resolution)
    encoder_fn.batch = batch_fn
    encoder_fn.ctx = {"lm": lm, "vision": vision, "tokenizer": tokenizer,
                      "eos_token_id": eos}
    return encoder_fn


def _internvl(lm, tokenize, cfg, vision, dev, no_vision, answer):
    """The InternVL2.5 family's host and device halves (``mllm_encoder``)."""
    cfg = cfg or InternVLConfig(llm=lm.cfg)
    ctx, per_tile = cfg.img_context_token_id, cfg.num_image_token

    def prepare(r):
        images = r.get("images") or []
        question = task_instruction(r.get("task", "text2image"),
                                    r.get("prompt"), num_images=len(images))
        tiles = None
        if images:
            if vision is None:
                no_vision()
            tiles = np.concatenate([image_tiles(im, cfg.vision.image_size)
                                    for im in images], axis=0)
            question = IMAGE_PREFIX + question
        query = internvl2_5_prompt(question)
        if tiles is not None:
            query = expand_image_tokens(query, [tiles.shape[0]], per_tile)
        ids, mask = tokenize(query)
        want = 0 if tiles is None else tiles.shape[0] * per_tile
        return ids, mask, tiles, int((ids == ctx).sum()) == want

    def forward(ids, mask, extras):
        ids = torch.as_tensor(ids, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        tiles = [t for t in extras if t is not None]
        if not tiles:
            return lm(ids, attention_mask=mask)[0]
        px = torch.as_tensor(np.concatenate(tiles, axis=0), device=dev)
        return vision(ids, mask, px)

    return lm_encoder(prepare, forward, answer)


def _qwenvl(lm, tokenizer, tokenize, cfg, visual, dev, eos, no_vision):
    """The Qwen2.5-VL family's host and device halves (``mllm_encoder``)."""
    cfg = cfg or Qwen2_5_VLConfig(
        vision=QwenVisionConfig(out_hidden_size=lm.cfg.hidden_size),
        llm=lm.cfg)
    v = cfg.vision
    merge_tokens = v.spatial_merge_size ** 2

    def prepare(r):
        images = r.get("images") or []
        video = r.get("video")
        text = tokenizer.apply_chat_template(
            qwen_chat_messages(r.get("task", "text2image"), r.get("prompt"),
                               num_images=len(images),
                               has_video=video is not None),
            tokenize=False, add_generation_prompt=True)
        vin = None
        if images or video is not None:
            if visual is None:
                no_vision()
            vin = prepare_vision_inputs(
                images or None, [video] if video is not None else None,
                patch_size=v.patch_size, merge_size=v.spatial_merge_size,
                temporal_patch_size=v.temporal_patch_size,
                window_size=v.window_size)
            # each pad token becomes its medium's merged-token count, the
            # video's keeping <|video_pad|> (get_rope_index and the fill
            # tell images from video by it)
            for pad, grids in (("<|image_pad|>", vin["image_grid_thw"]),
                               ("<|video_pad|>", vin["video_grid_thw"])):
                for grid in np.asarray(grids).reshape(-1, 3):
                    n = int(np.prod(grid)) // merge_tokens
                    text = text.replace(pad, "<|placeholder|>" * n, 1)
                text = text.replace("<|placeholder|>", pad)
        ids, mask = tokenize(text)
        pos3d, _ = get_rope_index(
            ids[None], image_grid_thw=(vin or {}).get("image_grid_thw"),
            video_grid_thw=(vin or {}).get("video_grid_thw"),
            attention_mask=mask[None].astype(np.int64),
            spatial_merge_size=v.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id)
        pads = int(((ids == cfg.image_token_id)
                    | (ids == cfg.video_token_id)).sum())
        want = 0 if vin is None else len(vin["reverse_index"])
        return ids, mask, (pos3d[:, 0], vin), pads == want

    def inputs(ids, mask, extras):
        return (torch.as_tensor(ids, device=dev),
                torch.as_tensor(mask, device=dev),
                torch.as_tensor(np.stack([e[0] for e in extras], axis=1),
                                device=dev),
                vision_tensors(concat_vision_inputs([e[1] for e in extras]),
                               dev))

    def forward(ids, mask, extras):
        ids, mask, pos3d, vin = inputs(ids, mask, extras)
        return encode_text(lm, cfg, ids, mask, pos3d, visual, vin)

    def answer(ids, mask, extra):
        ids, mask, pos3d, vin = inputs(ids, mask, [extra])
        return encode_with_answer(lm, cfg, ids, mask, pos3d, vin,
                                  max_new_tokens=ANSWER_TOKENS,
                                  eos_token_id=eos, visual=visual)[0]

    return lm_encoder(prepare, forward, answer)


def _unk_runs(ids: np.ndarray, unk: int) -> List[Tuple[int, int]]:
    """The (start, end) of each run of ``unk`` in ``ids``, in order; a run
    still open at the end of ``ids`` is not one (JAX's scan)."""
    spans, start = [], None
    for i, t in enumerate(ids.tolist()):
        if t == unk and start is None:
            start = i
        elif t != unk and start is not None:
            spans.append((start, i))
            start = None
    return spans


def _minicpm(lm, tokenizer, tokenize, cfg, encoder, dev, no_vision, answer,
             scale_resolution):
    """MiniCPM-o's host and device halves (``mllm_encoder``): JAX's
    ``_prep`` and ``_assemble``."""
    cfg = cfg or MiniCPMOConfig(llm=lm.cfg)
    unk = tokenizer.convert_tokens_to_ids("<unk>")
    v = cfg.vision

    def prepare(r):
        images = list(r.get("images") or [])
        if r.get("video") is not None:
            images.extend(r["video"])            # the frames, as images
        audio = r.get("audio")
        if (images or audio is not None) and encoder is None:
            no_vision()
        content = minicpm_omni_content(
            r.get("prompt"), num_images=len(images),
            num_audios=0 if audio is None else 1)
        aud_spans = ([] if audio is None
                     else audio_placeholder_spans(len(audio)))
        text = tokenizer.apply_chat_template(
            [{"role": "user", "content": content}], tokenize=False,
            add_generation_prompt=True)
        text = text.replace("(<image>./</image>)",
                            "<image>" + "<unk>" * cfg.query_num + "</image>")
        text = text.replace("(<audio>./</audio>)", "".join(
            "<audio>" + "<unk>" * n + "</audio>" for n in aud_spans))
        ids, mask = tokenize(text)
        spans = _unk_runs(ids, unk)
        mels = lens = None
        if audio is not None:
            mels, lens = chunk_audio_mels(np.asarray(audio))
        # a placeholder the 512-token budget cut would shift the rows of
        # every later request of a batch
        whole = (sum(e - s for s, e in spans)
                 == len(images) * cfg.query_num + sum(aud_spans))
        return ids, mask, {"images": images, "n_img": len(images),
                           "spans": spans, "mels": mels,
                           "mel_lens": lens}, whole

    def audio_inputs(preps, seq):
        """All requests' mel chunks padded to one Whisper batch, its frame
        mask and chunk bias, and the audio map over the batch's rows."""
        parts = [p for p in preps if p["mels"] is not None]
        t_max = max(p["mels"].shape[2] for p in parts)
        mels = np.zeros((sum(p["mels"].shape[0] for p in parts),
                         parts[0]["mels"].shape[1], t_max), np.float32)
        row = 0
        for p in parts:
            mels[row:row + p["mels"].shape[0], :, :p["mels"].shape[2]] = \
                p["mels"]
            row += p["mels"].shape[0]
        lens = np.concatenate([p["mel_lens"] for p in parts])
        conv_lens = (lens - 1) // 2 + 1
        pooled = ((t_max - 1) // 2 + 1) // 2
        rows, base = [], 0
        for p in parts:
            n = p["mels"].shape[0]
            r = np.concatenate([(base + k) * pooled + np.arange((c - 2) // 2
                                                                + 1)
                                for k, c in enumerate(
                                    conv_lens[base:base + n])])
            rows.append(r[:sum(e - s for s, e in p["spans"][p["n_img"]:])])
            base += n
        audio_map = bounds_to_map([p["spans"][p["n_img"]:] for p in preps],
                                  seq, rows=np.concatenate(rows))
        return (audio_tensors(mels, lens, dev),
                torch.as_tensor(audio_map, device=dev))

    def forward(ids, mask, extras):
        ids = torch.as_tensor(ids, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        if encoder is None:
            return lm(ids, attention_mask=mask)[0]
        seq = ids.shape[1]
        vision = prepare_minicpm_vision(
            [im for p in extras for im in p["images"]],
            cfg.llm.hidden_size, max_slice_nums=1, patch_size=v.patch_size,
            num_patches_per_side=v.num_patches_per_side,
            max_size=v.num_patches_per_side,
            scale_resolution=scale_resolution)
        vdict = img_map = adict = audio_map = None
        if vision is not None:
            vdict = slice_tensors(vision, dev)
            img_map = torch.as_tensor(bounds_to_map(
                [p["spans"][:p["n_img"]] for p in extras], seq), device=dev)
        if any(p["mels"] is not None for p in extras):
            adict, audio_map = audio_inputs(extras, seq)
        return encoder(ids, mask, vdict, adict, img_map, audio_map)

    return lm_encoder(prepare, forward, answer)


# ------------------------------------------------------------ pipeline

def _build(cls, cfg, device):
    """A module whose every parameter and buffer a checkpoint fills: made
    on the meta device, then given uninitialized storage on ``device``."""
    return cls(cfg, device="meta").to_empty(device=device)


def _lm_layout(model: str, mllm_path: str, llm_cfg):
    """-> (the LM's body prefix, its head key, whether a key is one the
    port does not read) in the family's checkpoint layout. The
    directories are read whole (their plans take the vision tower, and
    MiniCPM-o's the audio encoder, too), a tied head apart; of
    MiniCPM-o's also what ``minicpmo_off_path`` names for the registry's
    encoders over ``llm_cfg``."""
    tied = llm_cfg.tie_word_embeddings
    if "internvl" in model:
        body, head = "language_model.model.", "language_model.lm_head.weight"
    elif "minicpm" in model:
        return "llm.model.", "llm.lm_head.weight", minicpmo_off_path(
            MiniCPMOConfig(llm=llm_cfg))
    else:
        # Qwen2.5-VL: model.language_model.* beside model.visual.* (newer
        # transformers), or model.* beside visual.*
        new = any(k.startswith("model.visual.")
                  for k in safetensors_keys(mllm_path))
        body = "model.language_model." if new else "model."
        head = "lm_head.weight"
    return body, head, lambda k: tied and k == head


def load_tokenizer(path: str, cls: str = "AutoTokenizer", **kwargs):
    """``transformers.<cls>.from_pretrained(path, **kwargs)``: the one
    place the port imports ``transformers``, for a caller who passes no
    tokenizer (the machine with the card has none)."""
    import transformers
    return getattr(transformers, cls).from_pretrained(path, **kwargs)


def mllm_tokenizer(model: str, mllm_path: str):
    """The MLLM directory's own tokenizer, as JAX loads it (the slow one
    for InternVL)."""
    return load_tokenizer(
        mllm_path, trust_remote_code=True,
        **({"use_fast": False} if "internvl" in model else {}))


def load_mllm(model: str, mllm_path: str, tokenizer, device,
              dtype: Optional[torch.dtype] = None):
    """The family's whole encoder from an HF MLLM directory, in one pass
    over it: -> (its config, the module (``InternVLEncoder``,
    ``Qwen2_5_VLEncoder`` or ``MiniCPMOEncoder``), the load report). The
    architecture follows the directory's config.json, the registry entry
    where it is absent; InternVL's ``<IMG_CONTEXT>`` id is the
    tokenizer's. ``dtype``: every part's (the configs' when None)."""
    dev = resolve_device(device)
    spec = MODEL_REGISTRY[model]
    tensors = load_safetensors_dir(mllm_path)

    def typed(cfg):
        return cfg if dtype is None else with_dtype(cfg, dtype)

    if "internvl" in model:
        vl_cfg = typed(internvl_config_from_dir(mllm_path, spec.internvl)
                       or spec.internvl)
        ctx_id = tokenizer.convert_tokens_to_ids("<IMG_CONTEXT>")
        if ctx_id is not None and ctx_id >= 0:
            vl_cfg = replace(vl_cfg, img_context_token_id=ctx_id)
        *_, off_path = _lm_layout(model, mllm_path, vl_cfg.llm)
        enc = _build(InternVLEncoder, vl_cfg, dev)
        return vl_cfg, enc, fill_module(enc, tensors, internvl_plan(vl_cfg),
                                        off_path)
    if "qwenvl" in model:
        vl_cfg = typed(qwenvl_config_from_dir(mllm_path, spec.llm)
                       or Qwen2_5_VLConfig(vision=QwenVisionConfig(
                           out_hidden_size=spec.llm.hidden_size),
                           llm=spec.llm))
        body, head, off_path = _lm_layout(model, mllm_path, vl_cfg.llm)
        vis = "model.visual." if body == "model.language_model." else \
            "visual."
        enc = _build(Qwen2_5_VLEncoder, vl_cfg, dev)
        return vl_cfg, enc, fill_module(
            enc, tensors, qwen2_5_vl_plan(vl_cfg, vis, body, head), off_path)
    vl_cfg = typed(minicpmo_config_from_dir(mllm_path, spec.llm)
                   or spec.minicpmo)
    enc = _build(MiniCPMOEncoder, vl_cfg, dev)
    return vl_cfg, enc, fill_module(enc, tensors, minicpmo_plan(vl_cfg),
                                    minicpmo_off_path(vl_cfg))


def load_mllm_encoder(model: str, mllm_path: str, tokenizer, device=None):
    """``load_mllm``, then its ``mllm_encoder`` over the family's LM and
    vision module: -> (encoder_fn, the load report)."""
    vl_cfg, enc, report = load_mllm(model, mllm_path, tokenizer, device)
    scale = {}                       # MiniCPM-o's slices' side
    if "internvl" in model:
        lm, vision = enc.language_model, enc
    elif "qwenvl" in model:
        lm, vision = enc.language_model, enc.visual
    else:
        lm, vision = enc.llm, enc
        scale = {"scale_resolution": minicpm_scale_resolution(mllm_path)}
    return mllm_encoder(model, lm, tokenizer, vl_cfg, vision,
                        **scale), report


def internlm2_params_from_hf(tensors, cfg, device=None):
    """An InternLM2 checkpoint's (key, tensor) pairs -> (``Qwen2LM`` over
    ``cfg`` on the device, filled by ``internlm2_plan``, the load
    report): the counterpart of JAX's ``internlm2_params_from_hf``."""
    lm = _build(Qwen2LM, cfg, resolve_device(device))
    return lm, fill_module(lm, tensors, internlm2_plan(cfg))


def _weights(path: str):
    """A directory's safetensors, or its ``pytorch_model.bin`` when it has
    none (JAX's ``build_clip_scorer`` reads either)."""
    if safetensors_files(path):
        return load_safetensors_dir(path)
    return load_torch_bin(os.path.join(path, "pytorch_model.bin")).items()


def load_t5(t5_path: str, device=None, dtype=torch.bfloat16):
    """An HF T5EncoderModel directory (T5-XXL's encoder) -> (``T5Encoder``
    in ``dtype`` on the device, the load report), its architecture from
    the directory's config.json (``T5Config()`` without one). Unread: the
    keys of ``t5_off_path``."""
    cfg = replace(t5_config_from_dir(t5_path), dtype=dtype)
    t5 = _build(T5Encoder, cfg, resolve_device(device))
    return t5, fill_module(t5, _weights(t5_path), t5_plan(cfg), t5_off_path)


def load_clip_text(clip_path: str, device=None, dtype=torch.bfloat16):
    """An HF CLIP directory (a whole CLIPModel or a CLIPTextModel) -> (its
    text tower, ``CLIPTextEncoder`` in ``dtype`` on the device, the load
    report); unread: the vision tower, the projections, ``logit_scale``
    and the stored ``position_ids``."""
    text_cfg, _ = clip_configs_from_dir(clip_path, dtype)
    clip = _build(CLIPTextEncoder, text_cfg, resolve_device(device))
    return clip, fill_module(clip, _weights(clip_path),
                             clip_text_plan(text_cfg),
                             clip_off_path(text_only=True))


def load_clip(clip_path: str, device=None, dtype=torch.float32):
    """An HF CLIPModel directory -> (``CLIPModel``: both towers and the
    projections, in ``dtype`` on the device, the load report); unread:
    ``logit_scale`` and the stored ``position_ids``."""
    text_cfg, vision_cfg = clip_configs_from_dir(clip_path, dtype)
    model = CLIPModel(text_cfg, vision_cfg, device="meta").to_empty(
        device=resolve_device(device))
    return model, fill_module(model, _weights(clip_path),
                              clip_plan(text_cfg, vision_cfg),
                              clip_off_path(text_only=False))


def build_pipeline_from_checkpoints(model: str, flux_path: str,
                                    mllm_path: str, proj_path: str,
                                    num_steps: int = 4, height: int = 1024,
                                    width: int = 1024, seed: int = 0,
                                    quantized=True, device=None,
                                    tokenizer=None) -> X2IPipeline:
    """An ``X2IPipeline`` from checkpoint directories, for a registry
    model of any of the three families (the family is in the name:
    internvl, qwenvl, minicpm), the encoder whole (its vision tower, for
    MiniCPM-o also its audio encoder and projector, and its LM, read in
    one pass over the directory).

    The architecture follows each directory's own config files, the
    registry entry where a file is absent. ``quantized``: True is "w8",
    as in JAX, or a mode of ``QUANT_MODES``, or False; the DiT is loaded
    in its dtype, then quantized in place. ``device``: the card unless
    the caller names another ("cpu" in the tests). ``tokenizer``: an HF
    tokenizer (a callable with ``apply_chat_template`` and
    ``convert_tokens_to_ids``); None loads the one in ``mllm_path``
    through ``transformers``. InternVL's ``<IMG_CONTEXT>`` id is the
    tokenizer's, as the JAX loader takes it. On the card the DiT serves
    through the glue kernels (``FluxConfig.fused_glue``, as every serving
    path of the port does); on the CPU, where they would run as their
    plain versions, its glue stays unfused, as in JAX's loader. The
    pipeline's ``load_report`` gives, per module (flux, vae, proj, mllm),
    the tensors and bytes read and the keys the port does not read: the
    tied head, MiniCPM-o's TTS modules, its dropped SigLIP block and
    Whisper's stored position table."""
    dev = resolve_device(device)
    spec = MODEL_REGISTRY[model]
    mode = quant_mode("w8" if quantized is True else quantized)
    report: Dict[str, Any] = {}

    flux_cfg = flux_config_from_dir(flux_path, base=spec.flux) or spec.flux
    flux = _build(FluxTransformer2D,
                  replace(flux_cfg, fused_glue=dev.type == "cuda"), dev)
    report["flux"] = fill_module(
        flux, load_safetensors_dir(os.path.join(flux_path, "transformer")),
        flux_plan(flux_cfg))
    if mode:
        quantize_module_(flux, mode)
    vae_cfg = vae_config_from_dir(flux_path) or spec.vae
    vae = _build(AutoencoderKL, vae_cfg, dev)
    report["vae"] = fill_module(
        vae, load_safetensors_dir(os.path.join(flux_path, "vae")),
        vae_plan(vae_cfg))
    sched_cfg = scheduler_config_from_dir(flux_path) or spec.scheduler

    proj_sd = {k.removeprefix("module."): v
               for k, v in load_torch_bin(proj_path).items()}
    proj_cfg = proj_config_from_sd(proj_sd, base=spec.proj)
    proj = _build(Proj, proj_cfg, dev)
    report["proj"] = fill_module(proj, proj_sd.items(),
                                 proj_plan(proj_cfg, proj_sd))
    del proj_sd

    if tokenizer is None:
        tokenizer = mllm_tokenizer(model, mllm_path)
    encoder_fn, report["mllm"] = load_mllm_encoder(model, mllm_path,
                                                   tokenizer, dev)

    return X2IPipeline(
        encoder_fn=encoder_fn, proj=proj, flux=flux, vae=vae,
        scheduler=FlowMatchEulerScheduler(sched_cfg),
        gen_cfg=GenerationConfig(height=height, width=width,
                                 num_inference_steps=num_steps, seed=seed),
        encoder_batch_fn=encoder_fn.batch, load_report=report)
