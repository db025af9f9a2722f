"""The port's eval metrics (``x2i_torch/evalmetrics.py``) and CLIP vision
tower against the JAX package's on the CPU, on a tiny random HF
``CLIPModel`` (2 + 2 layers, 28^2 images in 7^2 patches): the vision
tower on the same flax tree in f32 within 2e-5; ``preprocess_clip_images``
bit for bit; ``CLIPScorer.clip_t`` and ``build_clip_scorer`` from a saved
directory with a BPE tokenizer within 1e-3 of JAX's scores;
``frechet_distance`` exactly JAX's; ``seed_matched_protocol``'s order;
and the attention dispatcher's route rule on meta tensors (bf16, and f32
forwards, on a kernel route under "auto")."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_params import one_thread  # noqa: F401 (autouse)

from x2i_tpu import evalmetrics as jeval
from x2i_tpu.convert.torch_models import (clip_params_from_hf,
                                          clip_vision_params_from_hf)
from x2i_tpu.models import clip as jclip
from x2i_torch import evalmetrics as teval
from x2i_torch.convert.torch_models import (clip_off_path, clip_plan,
                                            fill_module)
from x2i_torch.core import config as tcfg
from x2i_torch.models import clip as tclip
from x2i_torch.ops.attention import route
from x2i_torch.ops.flash_attention import MAX_KV_SEQ
from x2i_torch.params import load_flax

VISION_KW = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, image_size=28, patch_size=7,
                 projection_dim=16)
TEXT_KW = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               max_position_embeddings=24, eos_token_id=99)


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPConfig, CLIPModel
    torch.manual_seed(0)
    cfg = CLIPConfig(
        text_config=dict(TEXT_KW, bos_token_id=98, hidden_act="quick_gelu"),
        vision_config=dict({k: v for k, v in VISION_KW.items()
                            if k != "projection_dim"},
                           hidden_act="quick_gelu"),
        projection_dim=16)
    cfg._attn_implementation = "eager"
    return CLIPModel(cfg).eval().float()


@pytest.fixture(scope="module")
def clip_dir(hf_clip, tmp_path_factory):
    """The model saved by transformers with a tiny BPE tokenizer (the
    files of tests/test_evalmetrics.py)."""
    from transformers import CLIPTokenizer
    root = tmp_path_factory.mktemp("clip")
    path = str(root / "clip")
    hf_clip.save_pretrained(path)
    vocab = {"<|startoftext|>": 98, "<|endoftext|>": 99}
    for t in ([c for c in "abcdefghijklmnopqrstuvwxyz"]
              + [c + "</w>" for c in "abcdefghijklmnopqrstuvwxyz"]
              + ["ca", "cat</w>"]):
        vocab[t] = len(vocab) - 2
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\nc a\nca t</w>\n")
    CLIPTokenizer(str(root / "vocab.json"),
                  str(root / "merges.txt")).save_pretrained(path)
    return path


def _jax_vision():
    return jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(
        **VISION_KW, dtype=jnp.float32, param_dtype=jnp.float32))


def _jax_text():
    return jclip.CLIPTextEncoder(jclip.CLIPTextConfig(
        **TEXT_KW, dtype=jnp.float32, param_dtype=jnp.float32))


def _jax_scorer(sd, tokenize):
    return jeval.CLIPScorer(
        text_model=_jax_text(),
        text_params={"params": clip_params_from_hf(sd, 2)},
        vision_model=_jax_vision(),
        vision_params={"params": clip_vision_params_from_hf(sd, 2)},
        text_projection=jnp.asarray(sd["text_projection.weight"].numpy().T),
        visual_projection=jnp.asarray(
            sd["visual_projection.weight"].numpy().T),
        tokenize=tokenize)


def test_clip_vision_encoder_matches_jax(hf_clip):
    """The tower on the flax tree of JAX's converter, carried across by the
    bridge: last hidden state and pooled output, f32, 2e-5."""
    tree = {"params": clip_vision_params_from_hf(hf_clip.state_dict(), 2)}
    px = np.random.default_rng(1).standard_normal(
        (2, 28, 28, 3)).astype(np.float32)
    want = jax.jit(_jax_vision().apply)(tree, jnp.asarray(px))
    model = load_flax(tclip.CLIPVisionEncoder(tcfg.CLIPVisionConfig(
        **VISION_KW, dtype=torch.float32)), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(px))
    assert got[0].shape == (2, 17, 32) and got[1].shape == (2, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


def test_preprocess_clip_images_bit_for_bit():
    imgs = (np.random.default_rng(2).random((3, 40, 31, 3)) * 255).astype(
        np.uint8)
    for size in (28, 224):
        np.testing.assert_array_equal(
            teval.preprocess_clip_images(imgs, size),
            jeval.preprocess_clip_images(imgs, size))


def test_clip_scorer_matches_jax(hf_clip):
    """clip_t on uint8 images and on the host half's pixels (the card's
    route), the text and image features; 1e-3 of JAX's scores."""
    sd = hf_clip.state_dict()
    rng = np.random.default_rng(3)
    imgs = (rng.random((2, 40, 40, 3)) * 255).astype(np.uint8)
    ids = rng.integers(0, 97, (2, 10))
    ids[:, -1] = 99
    table = {str(i): ids[i] for i in range(2)}
    want = _jax_scorer(sd, table.__getitem__).clip_t(imgs, ["0", "1"])
    model = tclip.CLIPModel(
        tcfg.CLIPTextConfig(**TEXT_KW, dtype=torch.float32),
        tcfg.CLIPVisionConfig(**VISION_KW, dtype=torch.float32))
    fill_module(model, sd.items(), clip_plan(model.text_model.cfg,
                                             model.vision_model.cfg),
                clip_off_path(text_only=False))
    scorer = teval.scorer_from_model(model, table.__getitem__)
    np.testing.assert_allclose(scorer.clip_t(imgs, ["0", "1"]), want,
                               atol=1e-3)
    px = teval.preprocess_clip_images(imgs, 28)
    np.testing.assert_allclose(scorer.clip_t(px, ["0", "1"]), want,
                               atol=1e-3)
    np.testing.assert_allclose(
        scorer.clip_t(torch.from_numpy(px), ["0", "1"]), want, atol=1e-3)


def test_build_clip_scorer_matches_jax(clip_dir):
    """The one-call loader on the saved directory (config.json, weights,
    the BPE tokenizer through ``load_tokenizer``): the configs read, every
    key but logit_scale read, the token ids and scores JAX's."""
    scorer = teval.build_clip_scorer(clip_dir, device="cpu")
    ref = jeval.build_clip_scorer(clip_dir)
    assert scorer.text_model.cfg == tcfg.CLIPTextConfig(
        **TEXT_KW, dtype=torch.float32)
    assert scorer.vision_model.cfg == tcfg.CLIPVisionConfig(
        **VISION_KW, dtype=torch.float32)
    assert scorer.load_report["unread"] == ["logit_scale"]
    texts = ["a cat", "cab"]
    for t in texts:
        np.testing.assert_array_equal(scorer.tokenize(t), ref.tokenize(t))
    imgs = (np.random.default_rng(4).random((2, 40, 40, 3)) * 255).astype(
        np.uint8)
    np.testing.assert_allclose(scorer.clip_t(imgs, texts),
                               ref.clip_t(imgs, texts), atol=1e-3)


def test_frechet_distance_is_jaxs():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 8))
    b = rng.standard_normal((64, 8)) + 0.5
    for x, y in ((a, b), (a, a.copy()), (b, a)):
        assert teval.frechet_distance(x, y) == jeval.frechet_distance(x, y)
    assert abs(teval.frechet_distance(a, a.copy())) < 1e-6


def test_seed_matched_protocol_order():
    def generate(prompt, seed):
        return np.full((1, 2, 2, 3), 10 * int(prompt) + seed, np.uint8)

    got = teval.seed_matched_protocol(generate, ["1", "2"], [3, 4])
    want = jeval.seed_matched_protocol(generate, ["1", "2"], [3, 4])
    np.testing.assert_array_equal(got, want)
    assert list(got[:, 0, 0, 0]) == [13, 14, 23, 24]


@pytest.mark.parametrize("dtype, tokens, want", [
    (torch.bfloat16, 257, "pad"), (torch.bfloat16, 512, "kernel"),
    (torch.float32, 257, "pad"), (torch.float32, 512, "kernel"),
    (torch.float16, 257, "plain"), (torch.float16, 512, "plain")])
def test_dispatcher_routes_the_kernels_dtypes_under_auto(dtype, tokens,
                                                         want):
    """Off the CPU (meta tensors here) "auto" takes a kernel route where a
    CUDA kernel takes the inputs: the CLIP tower's 257 tokens pad to 384
    in bf16 and in f32 (K1's f32 instance), as JAX pads them in every
    dtype; above MAX_KV_SEQ kv tokens bf16 and f32 pad to K2 (its f32
    instance), and the route does not depend on autograd (f32 has its lse,
    K3 and K4 instances); f16 takes the plain route. "kernel" keeps its
    route in any dtype, and the CPU takes the plain route under "auto"."""
    q = torch.empty((4, tokens, 16, 64), dtype=dtype, device="meta")
    assert route(q, q) == want
    assert route(q, q, implementation="kernel") == (
        "pad" if tokens % 128 else "kernel")
    assert route(torch.empty(q.shape, dtype=dtype), q) == "plain"
    assert route(q, q, causal=True) == (
        "plain" if tokens % 128 else want)
    long_k = torch.empty((4, MAX_KV_SEQ + 1, 16, 64), dtype=dtype,
                         device="meta")
    assert route(q, long_k) == (
        "plain" if dtype == torch.float16 else "pad")
