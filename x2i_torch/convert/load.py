"""Checkpoints into the port: safetensors and torch files -> an assembled
``X2IPipeline``, the counterpart of ``x2i_tpu/convert/load.py`` on the
text path.

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
``transformers``, which is imported only when the caller passes none.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import sys
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from x2i_torch.convert.hf_config import (flux_config_from_dir,
                                         internvl_llm_config_from_dir,
                                         minicpmo_llm_config_from_dir,
                                         proj_config_from_sd,
                                         qwenvl_config_from_dir,
                                         scheduler_config_from_dir,
                                         vae_config_from_dir)
from x2i_torch.convert.torch_models import (fill_module, flux_plan,
                                            proj_plan, qwen2_plan,
                                            vae_off_path, vae_plan)
from x2i_torch.core.config import (MODEL_REGISTRY, GenerationConfig,
                                   quant_mode)
from x2i_torch.data.qwen_vision import get_rope_index
from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.qwen2_5_vl import (Qwen2_5_VLConfig, encode_text,
                                         encode_with_answer)
from x2i_torch.models.templates import (internvl2_5_prompt,
                                        minicpm_omni_content,
                                        qwen_chat_messages,
                                        task_instruction)
from x2i_torch.models.vae import AutoencoderKL
from x2i_torch.ops.quant import quantize_module_
from x2i_torch.pipeline import X2IPipeline, lm_text_encoder, resolve_device

# the safetensors dtypes the reader takes
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "F64": torch.float64, "I8": torch.int8,
          "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
          "I64": torch.int64, "BOOL": torch.bool}
SEQ = 512                     # the text path's padded prompt length
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


# ------------------------------------------------------------ encoders

def text_encoder(model: str, lm: Qwen2LM, tokenizer,
                 vl_cfg: Optional[Qwen2_5_VLConfig] = None):
    """The text encoder of ``model``'s family over ``lm``: encoder_fn
    (inputs) -> the hidden-state stack, with ``.batch`` (one 512-token
    prefill for a list of requests) and ``.ctx`` (the LM, the tokenizer
    and the EOS id, for callers that drive the LM). Every prompt is
    padded to 512 tokens on the tokenizer's own padding side.

    * InternVL2.5: the task instruction in the internvl2_5 template, the
      LM on its embeddings (the ViT fills no position of a text prompt);
    * Qwen2.5-VL: the chat messages through the tokenizer's chat
      template, 3-D positions from ``get_rope_index`` (padded positions
      at 1), the LM under their M-RoPE tables (``vl_cfg``'s sections, by
      default the released ones);
    * MiniCPM-o: the omni content (the raw prompt) as one user turn of
      the chat template, the LM at its plain positions.

    ``use_answer`` (reasoning2image) is Qwen2.5-VL's: a greedy answer of
    128 tokens after the prompt, ending at the tokenizer's EOS (151645
    where it has none), and the stack of prompt and answer; the other two
    families raise ValueError, as in JAX."""
    if "internvl" in model:
        def text(prompt):
            return internvl2_5_prompt(task_instruction("text2image", prompt))
    elif "qwenvl" in model:
        def text(prompt):
            return tokenizer.apply_chat_template(
                qwen_chat_messages("text2image", prompt), tokenize=False,
                add_generation_prompt=True)
    elif "minicpm" in model:
        def text(prompt):
            return tokenizer.apply_chat_template(
                [{"role": "user", "content": minicpm_omni_content(prompt)}],
                tokenize=False, add_generation_prompt=True)
    else:
        raise ValueError(f"unknown model family for {model}")

    def tokenize(prompt):
        enc = tokenizer(text(prompt), padding="max_length", max_length=SEQ,
                        truncation=True)
        return (np.asarray(enc["input_ids"], np.int64),
                np.asarray(enc["attention_mask"], bool))

    eos = tokenizer.eos_token_id or 151645
    forward = answer = None
    if "qwenvl" in model:
        cfg = vl_cfg or Qwen2_5_VLConfig(llm=lm.cfg)
        dev = lm.embed_tokens.weight.device

        def inputs(ids, mask):
            pos3d, _ = get_rope_index(ids,
                                      attention_mask=mask.astype(np.int64))
            return (torch.as_tensor(ids, device=dev),
                    torch.as_tensor(mask, device=dev),
                    torch.as_tensor(pos3d, device=dev))

        def forward(ids, mask):
            return encode_text(lm, cfg, *inputs(ids, mask))

        def answer(ids, mask):
            return encode_with_answer(lm, cfg, *inputs(ids, mask),
                                      max_new_tokens=ANSWER_TOKENS,
                                      eos_token_id=eos)[0]
    else:
        family = "internvl" if "internvl" in model else "minicpm"

        def answer(ids, mask):
            raise ValueError(f"use_answer is a Qwen2.5-VL feature; the "
                             f"{family} family has no answer-conditioned "
                             f"mode")

    encoder_fn, batch_fn = lm_text_encoder(lm, tokenize, forward, answer)
    encoder_fn.batch = batch_fn
    encoder_fn.ctx = {"lm": lm, "tokenizer": tokenizer, "eos_token_id": eos}
    return encoder_fn


# ------------------------------------------------------------ pipeline

def _build(cls, cfg, device):
    """A module whose every parameter and buffer a checkpoint fills: made
    on the meta device, then given uninitialized storage on ``device``."""
    return cls(cfg, device="meta").to_empty(device=device)


def _lm_layout(model: str, mllm_path: str, llm_cfg):
    """-> (the LM's body prefix, its head key, whether a key is off the
    text path) in the family's checkpoint layout."""
    tied = llm_cfg.tie_word_embeddings
    if "internvl" in model:
        body, head, lm = ("language_model.model.",
                          "language_model.lm_head.weight", "language_model.")
    elif "minicpm" in model:
        body, head, lm = "llm.model.", "llm.lm_head.weight", "llm."
    else:
        # Qwen2.5-VL: model.language_model.* beside model.visual.* (newer
        # transformers), or model.* beside visual.*
        new = any(k.startswith("model.visual.")
                  for k in safetensors_keys(mllm_path))
        vis = "model.visual." if new else "visual."
        body = "model.language_model." if new else "model."
        head = "lm_head.weight"
        return body, head, lambda k: (k.startswith(vis)
                                      or (tied and k == head))
    return body, head, lambda k: (not k.startswith(lm)
                                  or (tied and k == head))


def build_pipeline_from_checkpoints(model: str, flux_path: str,
                                    mllm_path: str, proj_path: str,
                                    num_steps: int = 4, height: int = 1024,
                                    width: int = 1024, seed: int = 0,
                                    quantized=True, device=None,
                                    tokenizer=None) -> X2IPipeline:
    """A text->image ``X2IPipeline`` from checkpoint directories, for a
    registry model of any of the three families (the family is in the
    name: internvl, qwenvl, minicpm).

    The architecture follows each directory's own config files, the
    registry entry where a file is absent. ``quantized``: True is "w8",
    as in JAX, or a mode of ``QUANT_MODES``, or False; the DiT is loaded
    in its dtype, then quantized in place. ``device``: the card unless
    the caller names another ("cpu" in the tests). ``tokenizer``: an HF
    tokenizer (a callable with ``apply_chat_template``); None loads the
    one in ``mllm_path`` through ``transformers``. The pipeline's
    ``load_report`` gives, per module, the tensors and bytes read and
    the keys off the text path left unread."""
    dev = resolve_device(device)
    spec = MODEL_REGISTRY[model]
    mode = quant_mode("w8" if quantized is True else quantized)
    report: Dict[str, Any] = {}

    flux_cfg = flux_config_from_dir(flux_path, base=spec.flux) or spec.flux
    flux = _build(FluxTransformer2D, flux_cfg, dev)
    report["flux"] = fill_module(
        flux, load_safetensors_dir(os.path.join(flux_path, "transformer")),
        flux_plan(flux_cfg))
    if mode:
        quantize_module_(flux, mode)
    vae_cfg = vae_config_from_dir(flux_path) or spec.vae
    vae = _build(AutoencoderKL, vae_cfg, dev)
    report["vae"] = fill_module(
        vae, load_safetensors_dir(os.path.join(flux_path, "vae")),
        vae_plan(vae_cfg), vae_off_path)
    sched_cfg = scheduler_config_from_dir(flux_path) or spec.scheduler

    proj_sd = {k.removeprefix("module."): v
               for k, v in load_torch_bin(proj_path).items()}
    proj_cfg = proj_config_from_sd(proj_sd, base=spec.proj)
    proj = _build(Proj, proj_cfg, dev)
    report["proj"] = fill_module(proj, proj_sd.items(), proj_plan(proj_cfg))
    del proj_sd

    vl_cfg = None
    if "qwenvl" in model:
        vl_cfg = (qwenvl_config_from_dir(mllm_path, spec.llm)
                  or Qwen2_5_VLConfig(llm=spec.llm))
        llm_cfg = vl_cfg.llm
    else:
        read = (internvl_llm_config_from_dir if "internvl" in model
                else minicpmo_llm_config_from_dir)
        llm_cfg = read(mllm_path, spec.llm) or spec.llm
    body, head, off_path = _lm_layout(model, mllm_path, llm_cfg)
    lm = _build(Qwen2LM, llm_cfg, dev)
    report["lm"] = fill_module(lm, load_safetensors_dir(mllm_path),
                               qwen2_plan(llm_cfg, body, head), off_path)

    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(
            mllm_path, trust_remote_code=True,
            **({"use_fast": False} if "internvl" in model else {}))
    encoder_fn = text_encoder(model, lm, tokenizer, vl_cfg)

    return X2IPipeline(
        encoder_fn=encoder_fn, proj=proj, flux=flux, vae=vae,
        scheduler=FlowMatchEulerScheduler(sched_cfg),
        gen_cfg=GenerationConfig(height=height, width=width,
                                 num_inference_steps=num_steps, seed=seed),
        encoder_batch_fn=encoder_fn.batch, load_report=report)
