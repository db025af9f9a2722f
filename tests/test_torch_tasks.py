"""The tasks with images and video end to end: the port's
``build_pipeline_from_checkpoints`` (on the CPU) and the JAX package's on
the same bf16 fixture directories, the same PIL images (drawn from numpy
seeds) and the same noise. InternVL2.5: ``image2image``,
``imagetext2image`` and ``x2image`` (several 28-pixel tiles an image at
the fixture's ViT size); Qwen2.5-VL (``tests/ckpt_fixtures.py``'s
directory): the same and ``video2image``; MiniCPM-o (SigLIP at 56^2
slices, the resampler, Whisper): the same, ``audio2image`` and an
``x2image`` with images and audio; a mixed ``run_batch`` (text, image,
video and, for MiniCPM-o, audio requests) through the one-vision-call
(and one-Whisper-call) batch path, and the guard that sends a batch whose
image or audio tokens the 512-token budget cut to the serial path, in
both packages.

Bars (bf16 on both sides): hidden-state stacks within 2e-2 of their
largest magnitude at the worst element and 1e-3 of it on average: the
vision tower adds a bf16 stage to the text path's (whose bar,
tests/test_torch_checkpoint_dirs.py's, is 1e-2 at the worst element): its
features differ by one bf16 step here and there (5e-4 at the fill), and
the difference grows to 3 steps of the final-normed layer (measured:
0.9% and 1.3% of the largest magnitude at the worst element, 2.3e-4 on
average, for one and for two Qwen2.5-VL images). uint8 images within 16
levels at the worst pixel and 1 level on average, as the text path's;
the port's batch equal to its serial encodes bit for bit on the CPU.

This file holds InternVL2.5's cases and the helpers; Qwen2.5-VL's are in
test_torch_tasks_qwenvl.py and MiniCPM-o's in test_torch_tasks_minicpm.py,
each file building only its family's pipelines, so that the test
runner's workers take the three files at once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ckpt_fixtures import build_flux_dir, build_proj_bin, build_qwenvl_dir
from test_torch_checkpoint_dirs import (IMG_MAX, IMG_MEAN, PX, STEPS,
                                        _to_bf16, _tokenizer,
                                        build_internvl_text_dir,
                                        build_minicpm_dir)
from test_torch_params import one_thread  # noqa: F401 (autouse)
from x2i_tpu.convert.load import \
    build_pipeline_from_checkpoints as jax_build
from x2i_torch.convert.load import build_pipeline_from_checkpoints
from x2i_torch.models.vae import postprocess

MODELS = {"internvl": "x2i-internvl2.5-1b", "qwenvl": "x2i-qwenvl2.5-7b",
          "minicpm": "x2i-minicpm-o-2.6"}
BUILDERS = {"internvl": build_internvl_text_dir, "qwenvl": build_qwenvl_dir,
            "minicpm": build_minicpm_dir}
PROJ_DIM = {"internvl": 32, "qwenvl": 48, "minicpm": 32}
STACK_MAX, STACK_MEAN = 2e-2, 1e-3


def pil(seed, w=100, h=80):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))


def frames(seed, n=4):
    return [pil(seed + i, 64, 48) for i in range(n)]


def build_pipes(tmp_path_factory, family):
    """{family: (port pipeline, JAX pipeline)}, bf16, for one family."""
    model = MODELS[family]
    root = str(tmp_path_factory.mktemp(f"tasks_{family}"))
    flux = build_flux_dir(root)
    mllm = BUILDERS[family](root)
    proj = build_proj_bin(root, in_channels=3, input_dim=PROJ_DIM[family])
    _to_bf16(root)
    kw = dict(num_steps=STEPS, height=PX, width=PX, quantized=False)
    port = build_pipeline_from_checkpoints(
        model, flux, mllm, proj, device="cpu",
        tokenizer=_tokenizer(mllm, family), **kw)
    return {family: (port, jax_build(model, flux, mllm, proj, **kw))}


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    return build_pipes(tmp_path_factory, "internvl")


def _stack_close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff, top = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= STACK_MAX * top and diff.mean() <= STACK_MEAN * top, (
        diff.max() / top, diff.mean() / top)


def _pixels_close(port, ref, inputs, seed=3):
    noise = np.random.default_rng(seed).standard_normal(
        (1, (PX // 16) ** 2, port.flux.cfg.in_channels)).astype(np.float32)
    pooled, embeds = port.encode(inputs)
    got = postprocess(port._generate(
        torch.from_numpy(noise).to(torch.bfloat16), embeds, pooled, PX, PX,
        STEPS)).numpy().astype(int)
    jpooled, jembeds = ref.encode(inputs)
    want = np.asarray(ref._generate_jit(
        ref.flux_params, ref.vae_params, jembeds, jpooled,
        jnp.asarray(noise, jnp.bfloat16), None, PX, PX, STEPS)).astype(int)
    assert got.shape == want.shape == (1, PX, PX, 3)
    assert np.unique(got).size > 1
    diff = np.abs(got - want)
    assert diff.max() <= IMG_MAX and diff.mean() <= IMG_MEAN, (
        diff.max(), diff.mean())


TASKS = {
    "image2image": dict(images=[pil(1)]),
    "imagetext2image": dict(prompt="make it snow", images=[pil(2)]),
    "x2image": dict(prompt="two of them", images=[pil(3), pil(4, 60, 90)]),
    "video2image": dict(video=frames(5)),
}

def wave(seed, seconds):
    """A 16 kHz clip drawn from a seed."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(16000 * seconds))).astype(
        np.float32)


# MiniCPM-o's requests: a clip of 2.5 s (62 tokens in spans of 25, 25, 12),
# and one of 31 s (two mel chunks, 775 tokens: the prompt is cut at 512)
MINICPM_TASKS = {
    **TASKS,
    "audio2image": dict(audio=wave(6, 2.5)),
    "x2image": dict(prompt="two of them", images=[pil(3), pil(4, 60, 90)],
                    audio=wave(7, 2.5)),
}
CASES = [("internvl", t) for t in TASKS if t != "video2image"] + [
    ("qwenvl", t) for t in TASKS] + [("minicpm", t) for t in MINICPM_TASKS]


def cases(family):
    return [c for c in CASES if c[0] == family]


def task_matches_jax(pipes, family, task):
    """The stack and the image of one request of the task."""
    port, ref = pipes[family]
    inputs = {"task": task, "prompt": None,
              **(MINICPM_TASKS if family == "minicpm" else TASKS)[task]}
    _stack_close(port.encoder_fn(inputs), ref.encoder_fn(inputs))
    _pixels_close(port, ref, inputs)


def _batch(family):
    reqs = [{"task": "text2image", "prompt": "a lighthouse at dusk"},
            {"task": "image2image", "images": [pil(10)]},
            {"task": "imagetext2image", "prompt": "in winter",
             "images": [pil(11), pil(12, 48, 64)]}]
    if family in ("qwenvl", "minicpm"):
        reqs.append({"task": "video2image", "video": frames(13, 3)})
    if family == "minicpm":
        reqs += [{"task": "audio2image", "audio": wave(14, 1.7)},
                 {"task": "x2image", "prompt": "and this",
                  "images": [pil(15)], "audio": wave(16, 3.2)}]
    return reqs


def _tower(port, family):
    vision = port.encoder_fn.ctx["vision"]
    if family == "internvl":
        return vision.vision_model
    return vision.vpm if family == "minicpm" else vision


def _counted(module):
    """A list that grows by one on every forward call of ``module``."""
    calls = []
    module.register_forward_hook(lambda *a: calls.append(1))
    return calls


def mixed_batch_matches_jax_and_serial(pipes, family):
    """One vision call for the whole batch (the JAX batch path's
    concatenation), and for MiniCPM-o one Whisper call for the mel chunks
    of all its audio requests, the stacks of JAX's batch path, and the
    port's serial encodes bit for bit; then ``run_batch`` makes one image
    per request. MiniCPM-o's batch pads every mel chunk to the batch's
    longest, and the reference's frame mask (conv-frame indices against
    mel lengths, which JAX keeps) lets a shorter clip's frames attend that
    padding, so its batch is not its serial encodes in JAX either: held to
    them at the stack bars (measured 4.4e-3 / 1.4e-5)."""
    port, ref = pipes[family]
    reqs = _batch(family)
    calls = _counted(_tower(port, family))
    audio_calls = (_counted(port.encoder_fn.ctx["vision"].apm)
                   if family == "minicpm" else [])
    batched = port.encoder_fn.batch(reqs)
    assert len(calls) == 1
    assert len(audio_calls) == (family == "minicpm")
    _stack_close(batched, ref.encoder_fn.batch(reqs))
    serial = torch.cat([port.encoder_fn(r) for r in reqs])
    if family == "minicpm":
        _stack_close(batched, serial.float().numpy())
    else:
        torch.testing.assert_close(batched, serial, rtol=0, atol=0)
    images = port.run_batch(reqs, height=PX, width=PX, num_steps=STEPS)
    assert images.shape == (len(reqs), PX, PX, 3)


def cut_image_tokens_send_the_batch_to_the_serial_path(pipes, family):
    """A request whose image tokens run past 512 tokens: both packages'
    batch paths fall back to encoding request by request (a cut row would
    shift every later row's features), and agree. InternVL: 16 images of
    9 tiles, 576 <IMG_CONTEXT> tokens in one span, cut at 512.
    Qwen2.5-VL: 6 tokens, two images of 256 and 246 pad tokens and their
    start and end tokens fill the 512 exactly, and the third image is cut
    whole (a span cut in its middle has no 3-D positions, in JAX too).
    MiniCPM-o: an image and 31 s of audio (two mel chunks, 775 audio
    tokens in 31 spans), cut at 512."""
    port, ref = pipes[family]
    many = ([pil(20 + i) for i in range(16)] if family == "internvl"
            else [pil(20, 128, 128), pil(21, 328, 48), pil(22)])
    reqs = [{"task": "imagetext2image", "prompt": "all of them",
             "images": many},
            {"task": "image2image", "images": [pil(40)]}]
    if family == "minicpm":
        reqs[0] = {"task": "x2image", "prompt": "all of it",
                   "images": [pil(20)], "audio": wave(41, 31.0)}
    calls = _counted(_tower(port, family))
    batched = port.encoder_fn.batch(reqs)
    assert len(calls) == 2                  # one vision call per request
    serial = torch.cat([port.encoder_fn(r) for r in reqs])
    torch.testing.assert_close(batched, serial, rtol=0, atol=0)
    _stack_close(batched, ref.encoder_fn.batch(reqs))


# ------------------------------------------------------------ InternVL2.5

@pytest.mark.parametrize("family,task", cases("internvl"))
def test_task_matches_jax(pipes, family, task):
    task_matches_jax(pipes, family, task)


@pytest.mark.parametrize("family", ["internvl"])
def test_mixed_batch_matches_jax_and_serial(pipes, family):
    mixed_batch_matches_jax_and_serial(pipes, family)


@pytest.mark.parametrize("family", ["internvl"])
def test_cut_image_tokens_send_the_batch_to_the_serial_path(pipes, family):
    cut_image_tokens_send_the_batch_to_the_serial_path(pipes, family)
