"""The port's InternVL2.5 encoder (x2i_torch/models/internvl.py) against
the JAX package's on the CPU, in float32 at tiny sizes, on the same
weights (carried across by the bridge) and the same numpy inputs drawn
from a seed: an InternViT block (with and without the qk RMSNorm), the
ViT at its table's grid and at grids the position table is resized to
(up and down), the bicubic weights bit for bit, the pixel shuffle,
``extract_feature`` and the ``<IMG_CONTEXT>`` fill with two images in one
row and over a batch of two rows; the pad route at head_dim 64 (17 tokens
padded to 128, 111 masked keys) with the JAX side's Pallas kernel in
interpret mode; the HF checkpoint plan against the JAX converter; the
registry's InternVL configs and the config reader field for field.

Tolerances: 2e-5 absolute on single ops of order 1 (the block, the
shuffle), 1e-4 through the models (float32 summation order through a few
blocks); the weights and the bicubic table bit for bit."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import one_thread, random_tree
from x2i_tpu.convert.hf_config import internvl_config_from_dir as jread
from x2i_tpu.convert.load import internvl_params_from_hf
from x2i_tpu.core import config as jcfg
from x2i_tpu.models import internvl as jiv
from x2i_torch.convert.hf_config import internvl_config_from_dir
from x2i_torch.convert.torch_models import fill_module, internvl_plan
from x2i_torch.core import config as tcfg
from x2i_torch.models import internvl as tiv
from x2i_torch.params import load_flax

jattn = importlib.import_module("x2i_tpu.ops.attention")
OP_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
CTX = 500                    # <IMG_CONTEXT> in the tiny LM's vocabulary
VIT_KW = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, image_size=28, patch_size=7)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def vit_cfgs(impl="plain", **kw):
    kw = {**VIT_KW, **kw}
    return (jcfg.InternViTConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                 **kw),
            tcfg.InternViTConfig(dtype=torch.float32, attention_impl=impl,
                                 **kw))


def vl_cfgs(impl="plain", **vit_kw):
    jv, tv = vit_cfgs(impl, **vit_kw)
    tokens = (jv.image_size // jv.patch_size) ** 2 // 4
    common = dict(img_context_token_id=CTX, num_image_token=tokens)
    return (jcfg.InternVLConfig(vision=jv, llm=jcfg.tiny_qwen2_config(),
                                **common),
            tcfg.InternVLConfig(vision=tv, llm=tcfg.tiny_qwen2_config(
                attention_impl=impl), **common))


def _pixels(rng, b, size):
    return rng.standard_normal((b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_internvit_block_matches_jax(qk_norm):
    jc, tc = vit_cfgs(qk_normalization=qk_norm)
    x = np.random.default_rng(1).standard_normal((2, 17, 32))
    block = jiv.InternViTBlock(jc)
    tree = random_tree(block.init, jnp.zeros((1, 17, 32)))
    want = block.apply(tree, jnp.asarray(x, jnp.float32))
    with torch.inference_mode():
        got = load_flax(tiv.InternViTBlock(tc), tree)(t(x))
    np.testing.assert_allclose(n(got), n(want), **OP_TOL)


def test_bicubic_weights_equal_jax():
    for i, o in ((4, 6), (4, 2), (32, 16), (32, 45), (3, 3)):
        np.testing.assert_array_equal(tiv.torch_bicubic_weights(i, o),
                                      jiv._torch_bicubic_weights(i, o))


@pytest.mark.parametrize("size", [28, 42, 14],
                         ids=["base grid", "grid 6 (up)", "grid 2 (down)"])
def test_internvit_matches_jax(size):
    """The table's 4 x 4 grid, and 6 x 6 and 2 x 2 grids whose position
    table is resized by torch's bicubic weights (no antialiasing)."""
    jc, tc = vit_cfgs()
    px = _pixels(np.random.default_rng(2), 2, size)
    vit = jiv.InternViT(jc)
    tree = random_tree(vit.init, jnp.zeros((1, 28, 28, 3)))
    want = vit.apply(tree, jnp.asarray(px))
    with torch.inference_mode():
        got = load_flax(tiv.InternViT(tc), tree)(t(px))
    assert got.shape == (2, 1 + (size // 7) ** 2, 32)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 6, 6, 8))
    want = jiv.pixel_shuffle(jnp.asarray(x, jnp.float32), 0.5)
    got = tiv.pixel_shuffle(t(x), 0.5)
    assert got.shape == (2, 3, 3, 32)
    np.testing.assert_array_equal(n(got), n(want))


def _encoder(jc, tc, seed=0):
    enc = jiv.InternVLEncoder(jc)
    s = 2 * jc.num_image_token + 8
    tree = random_tree(enc.init, jnp.zeros((1, s), jnp.int32),
                       jnp.ones((1, s), bool),
                       jnp.zeros((2, 28, 28, 3)), seed=seed)
    return enc, tree, load_flax(tiv.InternVLEncoder(tc), tree)


def test_extract_feature_matches_jax():
    jc, tc = vl_cfgs()
    enc, tree, model = _encoder(jc, tc)
    px = _pixels(np.random.default_rng(4), 3, 28)
    want = enc.apply(tree, jnp.asarray(px),
                     method=jiv.InternVLEncoder.extract_feature)
    with torch.inference_mode():
        got = model.extract_feature(t(px))
    assert got.shape == (3, 4, 64)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def _ids(rng, rows, ctx_runs, s=24):
    """Token ids (rows, s) with the runs (row, start, length) of
    <IMG_CONTEXT>, right-padded masks."""
    ids = rng.integers(0, 400, (rows, s))
    for r, start, length in ctx_runs:
        ids[r, start:start + length] = CTX
    mask = np.arange(s)[None] < np.array([s, s - 5][:rows])[:, None]
    return ids, mask


@pytest.mark.parametrize("case", ["two images in a row", "batch of two",
                                  "text only"])
def test_encoder_fill_matches_jax(case):
    """The k-th <IMG_CONTEXT> of the batch, row by row, takes feature row
    k: two images' tokens in one row, one image in each of two rows, or
    no image (the LM on the token ids)."""
    jc, tc = vl_cfgs()
    enc, tree, model = _encoder(jc, tc, seed=5)
    rng = np.random.default_rng(6)
    if case == "two images in a row":
        ids, mask = _ids(rng, 1, [(0, 3, 8)])
        px = _pixels(rng, 2, 28)
    elif case == "batch of two":
        ids, mask = _ids(rng, 2, [(0, 2, 4), (1, 9, 4)])
        px = _pixels(rng, 2, 28)
    else:
        ids, mask = _ids(rng, 2, [])
        px = None
    want = enc.apply(tree, jnp.asarray(ids), jnp.asarray(mask),
                     None if px is None else jnp.asarray(px))
    with torch.inference_mode():
        got = model(torch.as_tensor(ids), torch.as_tensor(mask),
                    None if px is None else t(px))
    assert got.shape == (ids.shape[0], 3, 24, 64)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_fill_takes_the_last_row_past_the_features():
    """More <IMG_CONTEXT> positions than feature rows: the extra ones
    take the last row, as JAX's clipped gather gives them."""
    emb = torch.zeros((1, 6, 2))
    sel = torch.tensor([[False, True, True, True, False, True]])
    feats = torch.tensor([[1.0, 1.0], [2.0, 2.0]])
    got = tiv.scatter_features(emb, sel, feats)
    assert got[0, :, 0].tolist() == [0.0, 1.0, 2.0, 2.0, 0.0, 2.0]


def test_kernel_route_matches_jax_interpret(monkeypatch):
    """head_dim 64: 17 ViT tokens take the dispatcher's pad route (to 128,
    111 masked keys, non-causal, no rope), the JAX side through its
    Pallas kernel in interpret mode, the port through the kernel's
    wrapper (its plain version on the CPU)."""
    jc, tc = vl_cfgs("kernel", hidden_size=128, num_attention_heads=2,
                     intermediate_size=128)
    enc = jiv.InternVLEncoder(jc)
    rng = np.random.default_rng(7)
    ids, mask = _ids(rng, 1, [(0, 3, 4)])
    px = _pixels(rng, 1, 28)
    tree = random_tree(enc.init, jnp.asarray(ids), jnp.asarray(mask),
                       jnp.asarray(px))
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(enc.apply)(tree, jnp.asarray(ids), jnp.asarray(mask),
                                  jnp.asarray(px))
    model = load_flax(tiv.InternVLEncoder(tc), tree)
    with torch.inference_mode():
        got = model(torch.as_tensor(ids), torch.as_tensor(mask), t(px))
    np.testing.assert_allclose(n(got), n(want), **TOL)


def hf_state_dict(cfg, seed=0):
    """A bf16 state dict in the HF InternVLChatModel layout, every key
    the port's plan reads, shaped as the port's module."""
    module = tiv.InternVLEncoder(cfg, device="meta")
    shapes = dict(module.named_parameters())
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(shapes[dst].shape, generator=g).to(torch.bfloat16)
            for k, (dst, _) in internvl_plan(cfg).items()}


@pytest.mark.parametrize("qk_norm", [False, True])
def test_hf_plan_matches_jax_converter(qk_norm):
    """Every parameter the plan fills equals the JAX converter's tree
    carried across by the bridge, bit for bit (bf16 modules)."""
    jc, _ = vl_cfgs(qk_normalization=qk_norm)
    tc = tcfg.InternVLConfig(
        vision=tcfg.InternViTConfig(qk_normalization=qk_norm, **VIT_KW),
        llm=tcfg.tiny_qwen2_config(dtype=torch.bfloat16),
        img_context_token_id=CTX, num_image_token=4)
    sd = hf_state_dict(tc)
    got = tiv.InternVLEncoder(tc)
    rep = fill_module(got, sd.items(), internvl_plan(tc))
    assert rep["unread"] == [] and rep["tensors"] == len(sd)
    want = load_flax(tiv.InternVLEncoder(tc), internvl_params_from_hf(sd, jc))
    ws = want.state_dict()
    for k, v in got.state_dict().items():
        assert v.dtype == ws[k].dtype and torch.equal(v, ws[k]), k


def _same_fields(t, j):
    """t and j agree on every field they share but the dtypes."""
    shared = {f for f in vars(t)} & {f for f in vars(j)} - {"dtype"}
    for name in shared:
        tv, jv = getattr(t, name), getattr(j, name)
        if hasattr(tv, "__dataclass_fields__"):
            _same_fields(tv, jv)
        else:
            assert tv == jv, (name, tv, jv)
    return shared


@pytest.mark.parametrize("name", ["x2i-internvl2.5-1b",
                                  "x2i-internvl2.5-4b"])
def test_registry_internvl_config_is_jaxs(name):
    t, j = tcfg.MODEL_REGISTRY[name].internvl, jcfg.MODEL_REGISTRY[name][
        "mllm"]
    assert _same_fields(t, j) >= {"vision", "llm", "downsample_ratio",
                                  "img_context_token_id", "num_image_token"}
    assert t.llm == tcfg.MODEL_REGISTRY[name].llm
    assert _same_fields(t.vision, j.vision) >= set(VIT_KW)


def test_internvl_config_reader_matches_jax(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"llm_config": {"hidden_size": 64, "num_attention_heads": 4,
                                  "num_hidden_layers": 3},
                   "vision_config": {**VIT_KW, "qk_normalization": True,
                                     "norm_type": "rms_norm",
                                     "image_size": 224},
                   "force_image_size": 28, "downsample_ratio": 0.5,
                   "ps_version": "v2"}, f)
    name = "x2i-internvl2.5-1b"
    got = internvl_config_from_dir(str(tmp_path),
                                   tcfg.MODEL_REGISTRY[name].internvl)
    want = jread(str(tmp_path), jcfg.MODEL_REGISTRY[name]["mllm"])
    _same_fields(got, want)
    assert got.num_image_token == 4 and got.vision.image_size == 28
    assert got.vision.qk_normalization and got.vision.use_rms_norm
    assert internvl_config_from_dir(str(tmp_path / "none"), got) is None
