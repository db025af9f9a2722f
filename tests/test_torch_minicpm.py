"""MiniCPM-o's encoders in the port (x2i_torch/data/minicpm_vision.py,
models/siglip.py, resampler.py, whisper_enc.py, minicpmo.py) against the
JAX package's on the CPU: the host half bit for bit (slicing grids,
resizes, patches, bucket ids, sincos slices, mel, placeholder lengths and
spans, a 75 s clip's three chunks, the scatter maps, the chunk bias and
Whisper's sinusoids), then each module in float32 at tiny sizes on the
same weights (carried across by the bridge) and the same numpy inputs
drawn from a seed: SigLIP NaViT, the resampler (one slice, and two of
different patch counts), Whisper with its frame mask and chunk bias, the
audio projector, and ``MiniCPMOEncoder`` with text and an image, audio,
multi-chunk audio, and an image with audio, on the plain route and with
``attention_impl="kernel"`` (the resampler's pad route through K1's
wrapper, its plain version on the CPU) against JAX's Pallas kernel in
interpret mode.

Tolerances: 2e-5 absolute on single ops of order 1 (a block, the
projector), 1e-4 through the models (float32 summation order through a
few blocks, relative to the largest magnitude for the encoder's stack,
whose outputs reach 5); the host half bit for bit."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from test_torch_params import one_thread, random_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.data import minicpm_vision as jmv
from x2i_tpu.models import minicpmo as jmo
from x2i_tpu.models import resampler as jres
from x2i_tpu.models import siglip as jsig
from x2i_tpu.models import whisper_enc as jwh
from x2i_torch.core import config as tcfg
from x2i_torch.data import minicpm_vision as tmv
from x2i_torch.models import minicpmo as tmo
from x2i_torch.models import resampler as tres
from x2i_torch.models import siglip as tsig
from x2i_torch.models import whisper_enc as twh
from x2i_torch.params import load_flax

jattn = importlib.import_module("x2i_tpu.ops.attention")
OP_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
VIT_KW = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
              num_attention_heads=4, image_size=112, patch_size=14)
AUDIO_KW = dict(num_mel_bins=80, d_model=16, encoder_layers=2,
                encoder_attention_heads=4, encoder_ffn_dim=32,
                max_source_positions=1500)
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)


def t(a):
    return torch.as_tensor(np.asarray(a))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_same(a, b):
    """Equal arrays (or nested lists, tuples and dicts of them), dtypes
    too."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def pil(seed, w, h):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))


# ------------------------------------------------------------ host half

SIZES = [(128, 128), (100, 80), (60, 90), (1000, 300), (896, 896),
         (2000, 1500), (14, 500)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_and_slice_grid_equal_jax(size):
    for scale in (448, 56):
        for up in (False, True):
            assert tmv.find_best_resize(size, scale, 14, up) == \
                jmv.find_best_resize(size, scale, 14, up)
        for slices in (1, 4, 9):
            for never in (False, True):
                assert tmv.best_slice_grid(size, slices, scale, never) == \
                    jmv.best_slice_grid(size, slices, scale, never)


@pytest.mark.parametrize("size,slices", [((128, 128), 1), ((100, 80), 1),
                                         ((1000, 700), 9), ((900, 400), 4)])
def test_sliced_patches_equal_jax(size, slices):
    """slice_image (PIL's bicubic resizes and crops), then each slice's
    patches in (c, py, px) order and its grid."""
    img = pil(sum(size), *size)
    got = tmv.slice_image(img, slices)
    want = jmv.slice_image(img, slices)
    assert [s.size for s in got] == [s.size for s in want]
    for a, b in zip(got, want):
        assert_same(tmv.patchify_siglip(a), jmv.patchify_siglip(b))


@pytest.mark.parametrize("grid", [(32, 32), (24, 40), (1, 7), (70, 70),
                                  (3, 5)])
def test_bucket_ids_and_sincos_equal_jax(grid):
    assert_same(tmv.bucket_position_ids(grid, 70),
                jmv.bucket_position_ids(grid, 70))
    assert_same(tmv.bucket_position_ids(grid, 4),
                jmv.bucket_position_ids(grid, 4))
    assert_same(tmv.get_2d_sincos_pos_embed(64, *grid),
                jres.get_2d_sincos_pos_embed(64, *grid))


def test_prepare_vision_equals_jax():
    """Two images of different sizes: slices padded to the longest, the
    mask, the ids and the sincos slices; and a host-half pair taken as it
    is (the card's route without PIL)."""
    images = [pil(1, 128, 128), pil(2, 100, 60)]
    kw = dict(max_slice_nums=1, patch_size=14, num_patches_per_side=8,
              max_size=8, scale_resolution=56)
    got = tmv.prepare_minicpm_vision(images, 64, **kw)
    assert_same(got, jmv.prepare_minicpm_vision(images, 64, **kw))
    assert got["patches"].shape[0] == 2 and not got["patch_mask"].all()
    pairs = [tmv.patchify_siglip(s) for im in images
             for s in tmv.slice_image(im, 1, 56)]
    assert_same(tmv.prepare_minicpm_vision(pairs, 64, **kw), got)
    assert tmv.prepare_minicpm_vision([], 64) is None


def test_mel_equals_jax():
    rng = np.random.default_rng(3)
    assert_same(tmv.mel_filterbank(), jmv.mel_filterbank())
    wave = (rng.standard_normal(16000 * 2) * 0.1).astype(np.float32)
    assert_same(tmv.log_mel_spectrogram(wave), jmv.log_mel_spectrogram(wave))


LENGTHS = [1, 159, 160, 161, 800, 16000, 16160, 80000, 123457, 480000,
           1200000]


@pytest.mark.parametrize("samples", LENGTHS)
def test_placeholder_math_equals_jax(samples):
    assert tmv.audio_placeholder_len(samples) == \
        jmv.audio_placeholder_len(samples)
    assert tmv.audio_placeholder_spans(samples) == \
        jmv.audio_placeholder_spans(samples)


def test_75s_clip_three_chunks_equal_jax():
    audio = (np.random.default_rng(4).standard_normal(75 * 16000)
             * 0.1).astype(np.float32)
    got = tmv.chunk_audio_mels(audio)
    assert_same(got, jmv.chunk_audio_mels(audio))
    assert got[0].shape == (3, 80, 3000)
    assert got[1].tolist() == [3000, 3000, 1500]
    assert tmv.audio_placeholder_spans(len(audio)) == [25] * 75


def test_bounds_to_map_equals_jax():
    bounds = [[(1, 4), (6, 8)], [], [(0, 3)]]
    assert_same(tmv.bounds_to_map(bounds, 10), jmv.bounds_to_map(bounds, 10))
    rows = np.array([5, 6, 7, 20, 21, 40, 41, 42])
    assert_same(tmv.bounds_to_map(bounds, 10, rows=rows),
                jmv.bounds_to_map(bounds, 10, rows=rows))
    with pytest.raises(ValueError, match="feature rows"):
        tmv.bounds_to_map(bounds, 10, rows=np.arange(9))


@pytest.mark.parametrize("frames,chunk,left", [(250, 50, -1), (1500, 50, -1),
                                               (37, 5, 2), (8, 3, 0)])
def test_chunk_bias_and_sinusoids_equal_jax(frames, chunk, left):
    assert_same(tmv.chunk_bias(frames, chunk, left),
                jwh.chunk_bias(frames, chunk, left))
    assert_same(tmv.sinusoidal_positions(frames, 16),
                jwh.sinusoidal_positions(frames, 16))


# ------------------------------------------------------------ modules

def vit_cfgs(impl="plain"):
    return (jsig.SiglipVisionConfig(**F32, **VIT_KW),
            tcfg.SiglipVisionConfig(dtype=torch.float32, attention_impl=impl,
                                    **VIT_KW))


def vision_inputs(rng, lengths, width=64, dim=588, table=64):
    """Padded slices of ``lengths`` patches each."""
    n_, l_ = len(lengths), max(lengths)
    return {"patches": rng.standard_normal((n_, l_, dim)).astype(np.float32),
            "position_ids": rng.integers(0, table, (n_, l_)).astype(
                np.int32),
            "patch_mask": np.arange(l_)[None] < np.array(lengths)[:, None],
            "pos_embed": rng.standard_normal((n_, l_, width)).astype(
                np.float32)}


def test_siglip_block_matches_jax():
    jc, tc = vit_cfgs()
    x = np.random.default_rng(5).standard_normal((2, 9, 32))
    mask = np.arange(9)[None] < np.array([[9], [5]])
    block = jsig.SiglipBlock(jc)
    tree = random_tree(block.init, jnp.zeros((1, 9, 32)), None)
    want = block.apply(tree, jnp.asarray(x, jnp.float32), jnp.asarray(mask))
    with torch.inference_mode():
        got = load_flax(tsig.SiglipBlock(tc), tree)(t(x).float(), t(mask))
    np.testing.assert_allclose(n(got), n(want), **OP_TOL)


def test_siglip_matches_jax():
    """Two slices of 16 and 9 patches (padded rows compared too: both
    packages compute them alike); 2 of 3 layers run (drop_last_layer)."""
    jc, tc = vit_cfgs()
    v = vision_inputs(np.random.default_rng(6), [16, 9])
    args = (v["patches"], v["position_ids"], v["patch_mask"])
    vit = jsig.SiglipVisionTransformer(jc)
    tree = random_tree(vit.init, *map(jnp.asarray, args))
    assert tree["params"]["block"]["q"]["kernel"].shape[0] == 2
    want = vit.apply(tree, *map(jnp.asarray, args))
    with torch.inference_mode():
        got = load_flax(tsig.SiglipVisionTransformer(tc), tree)(
            *map(t, args))
    np.testing.assert_allclose(n(got), n(want), **TOL)


def res_cfgs(impl="plain", heads=1, width=64):
    kw = dict(num_queries=4, embed_dim=width, num_heads=heads, kv_dim=32)
    return (jres.ResamplerConfig(**F32, **kw),
            tcfg.ResamplerConfig(dtype=torch.float32, attention_impl=impl,
                                 **kw))


def _res_tree(module, v, x):
    """A resampler tree with the queries and the raw proj at their scales
    (random_tree gives any other matrix 1 + 0.1 N(0, 1))."""
    tree = random_tree(module.init, jnp.asarray(x), jnp.asarray(
        v["pos_embed"]), jnp.asarray(v["patch_mask"]))
    p, rng = tree["params"], np.random.default_rng(8)
    d = p["proj"].shape[0]
    p["query"] = (0.02 * rng.standard_normal(p["query"].shape)).astype(
        np.float32)
    p["proj"] = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    return tree


@pytest.mark.parametrize("lengths", [[16], [16, 7]],
                         ids=["one slice", "two slices, 16 and 7 patches"])
def test_resampler_matches_jax(lengths):
    jc, tc = res_cfgs(heads=4)
    rng = np.random.default_rng(7)
    v = vision_inputs(rng, lengths)
    x = rng.standard_normal((len(lengths), max(lengths), 32)).astype(
        np.float32)
    res = jres.Resampler(jc)
    tree = _res_tree(res, v, x)
    want = res.apply(tree, jnp.asarray(x), jnp.asarray(v["pos_embed"]),
                     jnp.asarray(v["patch_mask"]))
    with torch.inference_mode():
        got = load_flax(tres.Resampler(tc), tree)(
            t(x), t(v["pos_embed"]), t(v["patch_mask"]))
    assert got.shape == (len(lengths), 4, 64)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_resampler_pad_route_matches_jax_interpret(monkeypatch):
    """Head size 64: 4 queries padded to 128 rows, 16 and 7 patches to
    128 keys (masked), non-causal: JAX's Pallas kernel in interpret mode
    against the port's K1 wrapper (its plain version on the CPU)."""
    jc, tc = res_cfgs("kernel", heads=1)
    rng = np.random.default_rng(9)
    v = vision_inputs(rng, [16, 7])
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    res = jres.Resampler(jc)
    tree = _res_tree(res, v, x)
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(res.apply)(tree, jnp.asarray(x),
                                  jnp.asarray(v["pos_embed"]),
                                  jnp.asarray(v["patch_mask"]))
    with torch.inference_mode():
        got = load_flax(tres.Resampler(tc), tree)(
            t(x), t(v["pos_embed"]), t(v["patch_mask"]))
    np.testing.assert_allclose(n(got), n(want), **TOL)


def whisper_cfgs(impl="plain", **kw):
    kw = {**AUDIO_KW, **kw}
    return (jwh.WhisperConfig(**F32, **kw),
            tcfg.WhisperConfig(dtype=torch.float32, attention_impl=impl,
                               **kw))


@pytest.mark.parametrize("masked", [False, True],
                         ids=["no mask or bias", "frame mask + chunk bias"])
def test_whisper_matches_jax(masked):
    """A 2-chunk batch of 60 mel frames (30 conv frames): the stem, the
    sinusoids, the blocks and final_ln; with the conv frames' mask of
    lengths 30 and 21 and 1 s chunks of 10 frames."""
    jc, tc = whisper_cfgs(num_mel_bins=8, max_source_positions=64)
    rng = np.random.default_rng(10)
    mel = rng.standard_normal((2, 8, 60)).astype(np.float32)
    mask = bias = None
    if masked:
        mask = np.arange(30)[None] < np.array([[30], [21]])
        bias = tmv.chunk_bias(30, 10)
    enc = jwh.WhisperEncoder(jc)
    tree = random_tree(enc.init, jnp.asarray(mel))
    want = enc.apply(tree, jnp.asarray(mel),
                     None if mask is None else jnp.asarray(mask),
                     None if bias is None else jnp.asarray(bias))
    with torch.inference_mode():
        got = load_flax(twh.WhisperEncoder(tc), tree)(
            t(mel), None if mask is None else t(mask),
            None if bias is None else t(bias))
    assert got.shape == (2, 30, 16)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("frames", [30, 25], ids=["even", "odd frames"])
def test_audio_projector_matches_jax(frames):
    """Linear, ReLU, linear, then the pool of 2 (an odd last frame
    dropped)."""
    x = np.random.default_rng(11).standard_normal((2, frames, 16))
    proj = jwh.AudioProjector(64, 2, **F32)
    tree = random_tree(proj.init, jnp.zeros((1, frames, 16)))
    want = proj.apply(tree, jnp.asarray(x, jnp.float32))
    with torch.inference_mode():
        got = load_flax(twh.AudioProjector(16, 64, 2, torch.float32), tree)(
            t(x).float())
    assert got.shape == (2, frames // 2, 64)
    np.testing.assert_allclose(n(got), n(want), **OP_TOL)


# ------------------------------------------------------------ encoder

def enc_cfgs(impl="plain"):
    jv, tv = vit_cfgs(impl)
    ja, ta = whisper_cfgs(impl, num_mel_bins=8, max_source_positions=64)
    common = dict(query_num=4, resampler_heads=1)
    return (jmo.MiniCPMOConfig(vision=jv, audio=ja,
                               llm=jcfg.tiny_qwen2_config(), **common),
            tcfg.MiniCPMOConfig(vision=tv, audio=ta,
                                llm=tcfg.tiny_qwen2_config(
                                    attention_impl=impl), **common))


def _maps(rows, s, img_spans, audio_spans, audio_rows=None):
    img = tmv.bounds_to_map(img_spans, s) if img_spans else None
    aud = (tmv.bounds_to_map(audio_spans, s, rows=audio_rows)
           if audio_spans else None)
    return img, aud


def encoder_case(case, rng):
    """(ids, mask, vision, audio, img_map, audio_map) of one case."""
    s = 40
    ids = rng.integers(0, 400, (2, s))
    mask = np.arange(s)[None] < np.array([[s], [s - 6]])
    vision = audio = img_map = audio_map = None
    if case in ("text + image", "image + audio"):
        # three slices (16, 16 and 9 patches): two in row 0, one in row 1
        vision = vision_inputs(rng, [16, 16, 9])
        img_map = tmv.bounds_to_map([[(2, 6), (8, 12)], [(3, 7)]], s)
    if case in ("audio", "image + audio"):
        # one chunk a row, 40 mel frames -> 20 conv -> 10 pooled rows; row
        # 1's clip is 30 frames long (15 conv, 7 pooled)
        audio = {"mel": rng.standard_normal((2, 8, 40)).astype(np.float32),
                 "frame_mask": np.arange(20)[None] < np.array([[40], [30]]),
                 "attn_bias": tmv.chunk_bias(20, 5)}
        rows = np.concatenate([np.arange(10), 10 + np.arange(7)])
        audio_map = tmv.bounds_to_map([[(14, 19), (21, 26)], [(14, 21)]], s,
                                      rows=rows)
    if case == "multi-chunk audio":
        # row 0 three chunks (40, 40, 18 frames), row 1 one (26): the
        # pooled pad rows of the short chunks are skipped
        lens = np.array([40, 40, 18, 26])
        mel = rng.standard_normal((4, 8, 40)).astype(np.float32)
        mel *= np.arange(40)[None, None] < lens[:, None, None]
        audio = {"mel": mel,
                 "frame_mask": np.arange(20)[None] < lens[:, None],
                 "attn_bias": tmv.chunk_bias(20, 5)}
        conv = (lens - 1) // 2 + 1
        rows = np.concatenate([k * 10 + np.arange((c - 2) // 2 + 1)
                               for k, c in enumerate(conv)])
        audio_map = tmv.bounds_to_map(
            [[(1, 11), (12, 22), (23, 27)], [(5, 11)]], s, rows=rows)
    return ids, mask, vision, audio, img_map, audio_map


def _jax_args(args):
    ids, mask, vision, audio, img_map, audio_map = args
    d = (lambda x: None if x is None else
         {k: jnp.asarray(v) for k, v in x.items()})
    a = (lambda x: None if x is None else jnp.asarray(x))
    return (jnp.asarray(ids), jnp.asarray(mask), d(vision), d(audio),
            a(img_map), a(audio_map))


def _torch_args(args):
    d = (lambda x: None if x is None else {k: t(v) for k, v in x.items()})
    ids, mask, vision, audio, img_map, audio_map = args
    a = (lambda x: None if x is None else t(x))
    return t(ids), t(mask), d(vision), d(audio), a(img_map), a(audio_map)


CASES = ["text + image", "audio", "multi-chunk audio", "image + audio"]


@pytest.fixture(scope="module")
def trees():
    """One JAX encoder tree (every module initialized) for all cases."""
    jc, _ = enc_cfgs()
    rng = np.random.default_rng(12)
    args = encoder_case("image + audio", rng)
    enc = jmo.MiniCPMOEncoder(jc)
    tree = random_tree(enc.init, *_jax_args(args), seed=13)
    p, d = tree["params"]["resampler"], 64
    p["query"] = (0.02 * rng.standard_normal(p["query"].shape)).astype(
        np.float32)
    p["proj"] = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    return tree


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("case", CASES)
def test_encoder_matches_jax(trees, case, impl, monkeypatch):
    """The stack of ``MiniCPMOEncoder.apply``: the slices' features at the
    image map's rows, the audio's at the audio map's, over a batch of two
    rows. "kernel": the JAX side on its Pallas kernel in interpret mode
    (the resampler's pad route; SigLIP's head size 8, Whisper's bias and
    the LM's causal short rows take XLA in both)."""
    jc, tc = enc_cfgs(impl)
    args = encoder_case(case, np.random.default_rng(14))
    enc = jmo.MiniCPMOEncoder(jc)
    if impl == "kernel":
        monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            want = jax.jit(enc.apply)(trees, *_jax_args(args))
    else:
        want = enc.apply(trees, *_jax_args(args))
    model = load_flax(tmo.MiniCPMOEncoder(tc), trees)
    ids, mask, _, _, img_map, audio_map = args
    with torch.inference_mode():
        got = model(*_torch_args(args))
        text = model.llm(t(ids), attention_mask=t(mask))[0]
    want = n(want)
    assert got.shape == want.shape == (2, 3, 40, 64)
    top = np.abs(want).max()
    np.testing.assert_allclose(n(got) / top, want / top, atol=1e-4, rtol=0)
    # the placeholders really took features (not the token embeddings)
    filled = [m for m in (img_map, audio_map) if m is not None]
    hit = np.any([m >= 0 for m in filled], axis=0)
    assert not torch.allclose(text[:, 0][torch.as_tensor(hit)],
                              got[:, 0][torch.as_tensor(hit)])


def test_fill_rows_takes_the_last_row_past_the_features():
    flat = torch.zeros((5, 2))
    feats = torch.tensor([[1.0, 1.0], [2.0, 2.0]])
    got = tmo.fill_rows(flat, feats, torch.tensor([-1, 0, 1, 7, -1]))
    assert got[:, 0].tolist() == [0.0, 1.0, 2.0, 2.0, 0.0]


def test_registry_minicpmo_configs_are_jaxs():
    """SigLIP-so400m, Whisper-medium, the resampler of the two MiniCPM-o
    entries (field for field, the dtypes apart)."""
    for name in ("x2i-minicpm-o-2.6", "x2i-minicpm-o-2.6-dev"):
        spec = tcfg.MODEL_REGISTRY[name]
        got, want = spec.minicpmo, jmo.MiniCPMOConfig(
            llm=jcfg.MODEL_REGISTRY[name]["mllm"])
        assert got.llm == spec.llm
        for a, b in ((got.vision, want.vision), (got.audio, want.audio),
                     (got.resampler_config(), want.resampler_config())):
            shared = (set(vars(a)) & set(vars(b))) - {"dtype", "param_dtype"}
            assert {f: getattr(a, f) for f in shared} == \
                {f: getattr(b, f) for f in shared}
        assert (got.query_num, got.audio_pool_step, got.resampler_heads) == \
            (want.query_num, want.audio_pool_step, want.resampler_heads)
        assert got.vision.effective_layers == 26
        assert got.resampler_config().embed_dim // \
            got.resampler_config().num_heads == 128


# ------------------------------------------------------------ checkpoints

def _released_sd(cfg, seed=0):
    """A bf16 MiniCPM-o state dict in the released layout: the LM's keys
    from the plan, the encoders' from ``minicpm_encoder_sd`` (with the
    keys JAX leaves unread)."""
    from test_torch_checkpoint_dirs import minicpm_encoder_sd
    from x2i_torch.convert.torch_models import minicpmo_plan
    g = torch.Generator().manual_seed(seed)
    shapes = {k: tuple(p.shape) for k, p in tmo.MiniCPMOEncoder(
        cfg, device="meta").named_parameters()}
    sd = {k: torch.randn(shapes[dst[0]], generator=g) for k, dst in
          minicpmo_plan(cfg).items() if k.startswith("llm.")}
    sd.update(minicpm_encoder_sd(cfg, g))
    return {k: v.to(torch.bfloat16) for k, v in sd.items()}


@pytest.mark.parametrize("kv_proj", [True, False],
                         ids=["kv_proj", "SigLIP at the LM's width"])
def test_plan_matches_jax_converter(kv_proj):
    """``minicpmo_plan`` through ``fill_module`` against JAX's
    ``minicpmo_params_from_hf`` carried across by the bridge, bit for bit
    (bf16 modules): the patch conv flattened in (c, py, px) order, the
    packed in-projection split, the convs in torch's layout, 2 of the 3
    SigLIP blocks; the dropped block, Whisper's stored position table and
    the TTS tensor unread and named. Without ``kv_proj`` (SigLIP as wide
    as the LM) the plan reads none."""
    from test_torch_checkpoint_dirs import minicpm_cfg
    from x2i_tpu.convert.load import minicpmo_params_from_hf
    from x2i_torch.convert.torch_models import (fill_module, minicpmo_off_path,
                                                minicpmo_plan)
    cfg = minicpm_cfg(torch.bfloat16)
    if not kv_proj:
        cfg = minicpm_cfg(torch.bfloat16, hidden_size=cfg.llm.hidden_size)
    sd = _released_sd(cfg)
    assert ("resampler.kv_proj.weight" in sd) == kv_proj
    got = tmo.MiniCPMOEncoder(cfg)
    rep = fill_module(got, sd.items(), minicpmo_plan(cfg),
                      minicpmo_off_path(cfg))
    unread = [k for k in sd if k.startswith(("tts.", "vpm.encoder.layers.2.",
                                             "apm.embed_positions."))]
    assert rep["unread"] == sorted(unread) and len(unread) > 3
    assert rep["tensors"] == len(sd) - len(unread)
    v, a, llm = cfg.vision, cfg.audio, cfg.llm
    jc = jmo.MiniCPMOConfig(
        vision=jsig.SiglipVisionConfig(**{f: getattr(v, f) for f in VIT_KW}),
        audio=jwh.WhisperConfig(**{f: getattr(a, f) for f in AUDIO_KW}),
        llm=jcfg.Qwen2Config(**{f: getattr(llm, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "head_dim", "tie_word_embeddings")}),
        query_num=cfg.query_num, resampler_heads=cfg.resampler_heads)
    want = load_flax(tmo.MiniCPMOEncoder(cfg),
                     minicpmo_params_from_hf(sd, jc)).state_dict()
    for k, val in got.state_dict().items():
        assert val.dtype == want[k].dtype and torch.equal(val, want[k]), k


def test_config_readers_match_jax(tmp_path):
    """``minicpmo_config_from_dir`` against JAX's, field for field (SigLIP
    and Whisper from their sub-dicts, query_num, audio_pool_step, the
    resampler's heads at width // 128), and the slices' scale from
    preprocessor_config.json (448 without it)."""
    import json

    from x2i_tpu.convert.hf_config import minicpmo_config_from_dir as jread
    from x2i_torch.convert.hf_config import (minicpm_scale_resolution,
                                             minicpmo_config_from_dir)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"hidden_size": 256, "num_attention_heads": 4,
                   "num_hidden_layers": 3, "vocab_size": 500,
                   "tie_word_embeddings": False, "query_num": 32,
                   "audio_pool_step": 4, "vision_config": VIT_KW,
                   "audio_config": {**AUDIO_KW, "d_model": 64}}, f)
    name = "x2i-minicpm-o-2.6"
    got = minicpmo_config_from_dir(str(tmp_path),
                                   tcfg.MODEL_REGISTRY[name].llm)
    want = jread(str(tmp_path), jcfg.MODEL_REGISTRY[name]["mllm"])
    for a, b in ((got.vision, want.vision), (got.audio, want.audio),
                 (got.llm, want.llm), (got, want)):
        shared = (set(vars(a)) & set(vars(b))) - {
            "dtype", "param_dtype", "vision", "audio", "llm"}
        assert {f: getattr(a, f) for f in shared} == \
            {f: getattr(b, f) for f in shared}
    assert got.resampler_heads == 2 and got.query_num == 32
    assert got.vision.effective_layers == 2 and got.audio.d_model == 64
    assert minicpmo_config_from_dir(str(tmp_path / "none"), got.llm) is None
    assert minicpm_scale_resolution(str(tmp_path)) == 448
    with open(tmp_path / "preprocessor_config.json", "w") as f:
        json.dump({"slice_config": {"scale_resolution": 336}}, f)
    assert minicpm_scale_resolution(str(tmp_path)) == 336
