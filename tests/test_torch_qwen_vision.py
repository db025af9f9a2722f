"""The port's Qwen2.5-VL vision side (x2i_torch/models/qwen2_5_vl.py)
against the JAX package's on the CPU, in float32 at tiny sizes, on the
same weights (carried across by the bridge) and the same inputs: the
tower's rope tables, a block under a window and under a full segment
bias, the tower on the host half's arrays of two images and a video,
``embed_multimodal`` (the features at the image and video pad positions
of a batch of two), the encoder's stack and ``encode_with_answer`` after
an image; and the HF checkpoint plan against the JAX converter on
``tests/ckpt_fixtures.py``'s Qwen2.5-VL directory.

The host arrays (patches, positions, segments, 3-D positions) come from
the JAX package's own host functions, which
tests/test_torch_vision_data.py holds the port's equal to. Tolerances:
2e-5 on the rope tables and one block, 1e-4 through the models (float32
summation order), token ids exactly, weights bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.torch import load_file

from ckpt_fixtures import build_qwenvl_dir
from test_torch_params import one_thread, random_tree
from x2i_tpu.convert.hf_config import qwenvl_config_from_dir as jreader
from x2i_tpu.convert.load import qwen2_5_vl_params_from_hf
from x2i_tpu.core import config as jcfg
from x2i_tpu.data import qwen_vision as jqv
from x2i_tpu.models import qwen2_5_vl as jvl
from x2i_torch.convert.hf_config import qwenvl_config_from_dir
from x2i_torch.convert.torch_models import fill_module, qwen2_5_vl_plan
from x2i_torch.core import config as tcfg
from x2i_torch.models import qwen2_5_vl as tvl
from x2i_torch.params import load_flax

OP_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
IMG, VID, START = 500, 501, 502
VIS_KW = dict(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
              patch_size=4, spatial_merge_size=2, temporal_patch_size=2,
              window_size=16, out_hidden_size=64, fullatt_block_indexes=(1,))
SECTION = (2, 3, 3)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def cfgs():
    tokens = dict(image_token_id=IMG, video_token_id=VID,
                  vision_start_token_id=START, mrope_section=SECTION)
    jc = jvl.Qwen2_5_VLConfig(
        vision=jvl.QwenVisionConfig(dtype=jnp.float32,
                                    param_dtype=jnp.float32, **VIS_KW),
        llm=jcfg.tiny_qwen2_config(), **tokens)
    tc = tvl.Qwen2_5_VLConfig(
        vision=tvl.QwenVisionConfig(dtype=torch.float32,
                                    attention_impl="plain", **VIS_KW),
        llm=tcfg.tiny_qwen2_config(), **tokens)
    return jc, tc


def pil(rng, w, h):
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))


def host_inputs(seed=0, video=True):
    """The host half of two images (40 x 56 and 24 x 24) and, with
    ``video``, three 32 x 48 frames: JAX's prepare_vision_inputs."""
    rng = np.random.default_rng(seed)
    images = [pil(rng, 56, 40), pil(rng, 24, 24)]
    frames = [pil(rng, 48, 32) for _ in range(3)] if video else None
    return jqv.prepare_vision_inputs(images, [frames] if video else None,
                                     patch_size=4, merge_size=2,
                                     window_size=16)


def request_ids(rng, vin_list, s=256):
    """Token ids (B, s) and right-padded masks: per row some text, then
    per medium <vision_start> and its pad run (merged-token count), then
    text."""
    rows, masks = [], []
    for vin in vin_list:
        toks = list(rng.integers(0, 400, 5))
        grids = ([(g, IMG) for g in vin["image_grid_thw"]]
                 + [(g, VID) for g in vin["video_grid_thw"]]
                 if vin is not None else [])
        for grid, pad in grids:
            toks += [START] + [pad] * (int(np.prod(grid)) // 4) + [503]
            toks += list(rng.integers(0, 400, 3))
        assert len(toks) <= s
        mask = np.arange(s) < len(toks)
        rows.append(np.array(toks + [0] * (s - len(toks))))
        masks.append(mask)
    return np.stack(rows), np.stack(masks)


def vision_dict(vin):
    return {k: jnp.asarray(vin[k]) for k in tvl.VISION_KEYS}


def encoder(jc, tc, seed=0):
    vin = host_inputs()
    ids, mask = request_ids(np.random.default_rng(1), [vin])
    enc = jvl.Qwen2_5_VLEncoder(jc)
    pos3d = np.zeros((3,) + ids.shape, np.int64)
    tree = random_tree(enc.init, jnp.asarray(ids), jnp.asarray(mask),
                       jnp.asarray(pos3d), vision_dict(vin), seed=seed)
    return enc, tree, load_flax(tvl.Qwen2_5_VLEncoder(tc), tree)


def test_vision_rope_matches_jax():
    pos = np.random.default_rng(2).integers(0, 40, (30, 2))
    want = jvl.vision_rope(jnp.asarray(pos), 16)
    got = tvl.vision_rope(torch.as_tensor(pos), 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **OP_TOL)


@pytest.mark.parametrize("full", [False, True], ids=["window", "full"])
def test_vision_block_matches_jax(full):
    jc, tc = cfgs()
    rng = np.random.default_rng(3)
    s = 24
    x = rng.standard_normal((s, 32))
    cos, sin = (np.asarray(a) for a in jvl.vision_rope(
        jnp.asarray(rng.integers(0, 6, (s, 2))), 8))
    seg_w, seg_f = np.repeat(np.arange(6), 4), np.repeat(np.arange(2), 12)
    bias_w, bias_f = (np.where(a[:, None] == a[None], 0.0, -1e30)[None, None]
                      .astype(np.float32) for a in (seg_w, seg_f))
    block = jvl.QwenVisionBlock(jc.vision)
    args = [jnp.asarray(a, jnp.float32) for a in (x, cos, sin, bias_f,
                                                  bias_w)]
    tree = random_tree(block.init, *args, jnp.asarray(True))
    want = block.apply(tree, *args, jnp.asarray(full))
    with torch.inference_mode():
        got = load_flax(tvl.QwenVisionBlock(tc.vision), tree)(
            t(x), t(cos), t(sin), t(bias_f if full else bias_w))
    np.testing.assert_allclose(n(got), n(want), **OP_TOL)


@pytest.mark.parametrize("video", [False, True], ids=["images", "images "
                                                      "and a video"])
def test_vision_tower_matches_jax(video):
    """The tower's merged features, and ``encode_vision``'s reverse
    window permutation, on the host half's arrays."""
    jc, tc = cfgs()
    enc, tree, model = encoder(jc, tc)
    vin = host_inputs(4, video)
    want = enc.apply(tree, *vision_dict(vin).values(),
                     method=jvl.Qwen2_5_VLEncoder.encode_vision)
    with torch.inference_mode():
        got = tvl.encode_vision(model.visual, tvl.vision_tensors(vin, "cpu"))
    assert got.shape == (len(vin["reverse_index"]), 64)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def _batch(seed=5):
    """Two requests, the first with two images and a video, the second
    with one image, merged as the batch path merges them."""
    rng = np.random.default_rng(seed)
    vins = [host_inputs(seed), jqv.prepare_vision_inputs(
        [pil(rng, 32, 32)], patch_size=4, merge_size=2, window_size=16)]
    ids, mask = request_ids(rng, vins)
    merged = jqv.concat_vision_inputs(vins)
    pos3d, _ = jqv.get_rope_index(
        ids, merged["image_grid_thw"], merged["video_grid_thw"],
        mask.astype(np.int64), image_token_id=IMG, video_token_id=VID,
        vision_start_token_id=START)
    return ids, mask, pos3d, merged


def test_embed_multimodal_matches_jax():
    jc, tc = cfgs()
    enc, tree, model = encoder(jc, tc)
    ids, _, _, vin = _batch()
    want = enc.apply(tree, jnp.asarray(ids), vision_dict(vin),
                     method=jvl.Qwen2_5_VLEncoder.embed_multimodal)
    with torch.inference_mode():
        got = tvl.embed_multimodal(model.language_model, tc,
                                   torch.as_tensor(ids), model.visual,
                                   tvl.vision_tensors(vin, "cpu"))
    np.testing.assert_allclose(n(got), n(want), **TOL)
    pads = (ids == IMG) | (ids == VID)
    assert pads.sum() == len(vin["reverse_index"])
    with torch.inference_mode():
        emb = model.language_model.embed(torch.as_tensor(ids))
    np.testing.assert_array_equal(n(got)[~pads], n(emb)[~pads])


def test_encoder_stack_matches_jax():
    jc, tc = cfgs()
    enc, tree, model = encoder(jc, tc)
    ids, mask, pos3d, vin = _batch(6)
    want = enc.apply(tree, jnp.asarray(ids), jnp.asarray(mask),
                     jnp.asarray(pos3d), vision_dict(vin))
    with torch.inference_mode():
        got = tvl.encode_text(model.language_model, tc,
                              torch.as_tensor(ids), torch.as_tensor(mask),
                              torch.as_tensor(pos3d), model.visual,
                              tvl.vision_tensors(vin, "cpu"))
    assert got.shape == (2, 3, 256, 64)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_encode_with_answer_after_an_image_matches_jax():
    """``use_answer`` after an image: the prompt's prefill with the
    tower's features, 6 greedy tokens from max(pos3d) + 1."""
    jc, tc = cfgs()
    enc, tree, model = encoder(jc, tc, seed=7)
    rng = np.random.default_rng(7)
    vin = jqv.prepare_vision_inputs([pil(rng, 40, 40)], patch_size=4,
                                    merge_size=2, window_size=16)
    ids, mask = request_ids(rng, [vin], s=64)
    pos3d, _ = jqv.get_rope_index(
        ids, vin["image_grid_thw"], None, mask.astype(np.int64),
        image_token_id=IMG, video_token_id=VID, vision_start_token_id=START)
    want = jvl.encode_with_answer(enc, tree, jnp.asarray(ids),
                                  jnp.asarray(mask), jnp.asarray(pos3d),
                                  vision_dict(vin), max_new_tokens=6,
                                  eos_token_id=-1)
    got = tvl.encode_with_answer(
        model.language_model, tc, torch.as_tensor(ids),
        torch.as_tensor(mask), torch.as_tensor(pos3d),
        tvl.vision_tensors(vin, "cpu"), max_new_tokens=6, eos_token_id=-1,
        visual=model.visual)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert tuple(got[0].shape) == (1, 3, 64 + 6, 64)
    np.testing.assert_allclose(n(got[0]), n(want[0]), **TOL)


def test_hf_plan_matches_jax_converter(tmp_path):
    """The fixture directory (``visual.*`` beside ``model.*`` or the
    newer ``model.visual.*`` beside ``model.language_model.*``, as the
    installed transformers writes it) through the port's config reader
    and plan, against the JAX reader and converter carried across by the
    bridge: every parameter bit for bit."""
    path = build_qwenvl_dir(str(tmp_path))
    sd = load_file(f"{path}/model.safetensors")
    jc = jreader(path, jcfg.MODEL_REGISTRY["x2i-qwenvl2.5-7b"]["mllm"])
    tc = qwenvl_config_from_dir(
        path, tcfg.MODEL_REGISTRY["x2i-qwenvl2.5-7b"].llm)
    new = any(k.startswith("model.visual.") for k in sd)
    vis, body = (("model.visual.", "model.language_model.") if new
                 else ("visual.", "model."))
    got = tvl.Qwen2_5_VLEncoder(tc)
    rep = fill_module(got, sd.items(), qwen2_5_vl_plan(tc, vis, body))
    assert rep["unread"] == [] and rep["tensors"] == len(sd)
    want = load_flax(tvl.Qwen2_5_VLEncoder(tc), qwen2_5_vl_params_from_hf(
        sd, jc.llm, vision_depth=jc.vision.depth))
    ws = want.state_dict()
    for k, v in got.state_dict().items():
        assert torch.equal(v, ws[k]), k
