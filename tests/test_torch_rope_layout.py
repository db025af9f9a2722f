"""The interleaved rope layout of the port's FLUX (``FluxConfig.
rope_layout="interleaved"``) and the InternLM2 converter, against the JAX
package on the CPU: the interleaved tables and rotation (2e-5 in f32), the
tiny interleaved FLUX on the same weights (1e-4, the models' bar), the
port's interleaved model against its half-layout model on the permuted
weights (``set_rope_layout_``, there and back bit for bit, quantized
layers too), and the interleaved FLUX plan and ``internlm2_plan`` bit for
bit against JAX's converters carried across by the bridge."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_convert import (FLUX_KW, LLM_KW, assert_same_params,
                                bf16_sd, save)
from test_torch_models import _flux_inputs, n, t
from test_torch_params import flux_tree, one_thread
from torch_mirrors import MirrorFluxTransformer2D
from x2i_tpu.convert import torch_models as jtm
from x2i_tpu.core import config as jcfg
from x2i_tpu.models import flux as jflux
from x2i_tpu.ops import rope as jrope
from x2i_torch.convert import load as tload
from x2i_torch.convert import torch_models as ttm
from x2i_torch.core import config as tcfg
from x2i_torch.models.flux import FluxTransformer2D, set_rope_layout_
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.ops import rope as trope
from x2i_torch.ops.quant import QuantLinear, quantize_module_
from x2i_torch.params import load_flax

TOL = dict(atol=1e-4, rtol=1e-4)
S_IMG, S_TXT = 16, 8


def _ids(rng):
    grid = rng.integers(0, 64, (S_TXT + S_IMG, 3))
    return grid.astype(np.float32)


@pytest.mark.parametrize("axes", [(8, 12, 12), (16, 56, 56)])
def test_interleaved_tables_and_rotation_match_jax(axes):
    rng = np.random.default_rng(0)
    ids = _ids(rng)
    cos, sin = trope.flux_rope_freqs(torch.from_numpy(ids), axes)
    jcos, jsin = jrope.flux_rope_freqs(jnp.asarray(ids), axes)
    np.testing.assert_allclose(n(cos), n(jcos), atol=2e-5, rtol=0)
    np.testing.assert_allclose(n(sin), n(jsin), atol=2e-5, rtol=0)
    x = rng.standard_normal((2, len(ids), 3, sum(axes))).astype(np.float32)
    got = trope.apply_rope_interleaved(t(x), cos[:, None], sin[:, None])
    want = jrope.apply_rope_interleaved(jnp.asarray(x), jcos[:, None],
                                        jsin[:, None])
    np.testing.assert_allclose(n(got), n(want), atol=2e-5, rtol=0)
    # the half layout on channels permuted by half_layout_perm is the same
    # rotation
    perm = trope.half_layout_perm(sum(axes))
    hc, hs = trope.flux_rope_freqs_half(torch.from_numpy(ids), axes)
    half = trope.apply_rope_half(t(x[..., perm]), hc, hs)
    np.testing.assert_allclose(n(half), n(got)[..., perm], atol=2e-5, rtol=0)


def _interleaved_pair(fused):
    jc = jcfg.tiny_flux_config(rope_layout="interleaved", fused_glue=fused)
    tc = tcfg.tiny_flux_config(rope_layout="interleaved", fused_glue=fused)
    return jc, tc


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_interleaved_flux_matches_jax(fused):
    """The interleaved tiny FLUX on JAX's interleaved tree: the qk norm and
    the rotation outside the attention (also in the fused glue mode,
    where the port keeps its ln_mod glue and JAX its)."""
    jc, tc = _interleaved_pair(fused)
    rng = np.random.default_rng(1)
    x = _flux_inputs(rng, jc, S_IMG, S_TXT)
    args = [x[k] for k in ("lat", "txt", "pooled", "t", "img_ids",
                           "txt_ids")]
    tree = flux_tree(1, jc, S_IMG, S_TXT)
    with pltpu.force_tpu_interpret_mode():     # JAX's ln_mod glue kernel
        want = jax.jit(jflux.FluxTransformer2D(jc).apply)(
            tree, *(jnp.asarray(a) for a in args))
    model = load_flax(FluxTransformer2D(tc), tree)
    assert model.cfg.glue == ("ln" if fused else None)
    with torch.inference_mode():
        got = model(*(t(a) for a in args))
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_rope_layout_is_validated():
    with pytest.raises(ValueError, match="rope_layout"):
        tcfg.tiny_flux_config(rope_layout="pairs")


@pytest.mark.parametrize("mode", [False, "w8", "w8a8", "w4", "w4a8"],
                         ids=["f32", "w8", "w8a8", "w4", "w4a8"])
def test_set_rope_layout_is_the_permutation_and_reversible(mode):
    """The interleaved model permuted into the half layout makes the same
    velocity (float32, plain routes; w8a8's and w4a8's activation codes
    may flip where sums cross a rounding boundary, so those modes are
    held to the round trip only), and back again every tensor is bit for
    bit what it was. Quantized layers permute their codes, scales and
    bias."""
    _, tc = _interleaved_pair(False)
    tree = flux_tree(2, jcfg.tiny_flux_config(), S_IMG, S_TXT)
    inter = load_flax(FluxTransformer2D(tc), tree)
    if mode:
        quantize_module_(inter, mode)
        assert isinstance(inter.single_blocks[0].q, QuantLinear)
    before = {k: v.clone() for k, v in inter.state_dict().items()}
    half = set_rope_layout_(copy.deepcopy(inter), "half")
    assert half.cfg.rope_layout == "half"
    assert half.single_blocks[0].cfg.rope_layout == "half"
    args = [t(a) for a in _flux_inputs(np.random.default_rng(2),
                                       jcfg.tiny_flux_config(), S_IMG,
                                       S_TXT).values()]
    if mode in (False, "w8", "w4"):
        with torch.inference_mode():
            np.testing.assert_allclose(n(half(*args)), n(inter(*args)),
                                       atol=2e-5, rtol=0)
    back = set_rope_layout_(half, "interleaved")
    assert back.cfg.rope_layout == "interleaved"
    for k, v in back.state_dict().items():
        assert torch.equal(v, before[k]), k
    moved = [k for k, v in set_rope_layout_(copy.deepcopy(inter), "half")
             .state_dict().items() if not torch.equal(v, before[k])]
    assert "single_blocks.0.q_norm.scale" in moved
    assert all(".v." not in k and "_v." not in k for k in moved)


def test_set_rope_layout_matches_jax_permutation():
    """Into the half layout, the port's permutation is JAX's
    ``permute_params_to_half_rope`` on the same tree."""
    jc, tc = _interleaved_pair(False)
    tree = flux_tree(4, jc, S_IMG, S_TXT)
    ported = set_rope_layout_(load_flax(FluxTransformer2D(tc), tree), "half")
    want = load_flax(FluxTransformer2D(dataclasses.replace(
        tc, rope_layout="half")), jflux.permute_params_to_half_rope(
            tree, jcfg.tiny_flux_config()))
    assert_same_params(ported, want)


def test_interleaved_flux_plan_matches_jax_converter(tmp_path):
    """A diffusers checkpoint into an interleaved model: the q/k rows and
    qk-norm scales as stored, bit for bit JAX's interleaved tree."""
    mirror = MirrorFluxTransformer2D(**FLUX_KW, time_embed_channels=256)
    sd = bf16_sd(mirror, 5)
    path = save(sd, str(tmp_path / "t.safetensors"))
    tc = tcfg.FluxConfig(**FLUX_KW, rope_layout="interleaved")
    jc = jcfg.FluxConfig(**FLUX_KW, rope_layout="interleaved")
    ported = FluxTransformer2D(tc)
    rep = ttm.fill_module(ported, tload.read_safetensors(path),
                          ttm.flux_plan(tc))
    assert rep["tensors"] == len(sd) and rep["unread"] == []
    bridged = load_flax(FluxTransformer2D(tc),
                        jtm.flux_params_from_diffusers(sd, jc))
    assert_same_params(ported, bridged)
    w = sd["transformer_blocks.0.attn.to_q.weight"]
    assert torch.equal(ported.double_blocks[0].img_q.weight, w)


def _internlm2_sd(cfg, g, untied):
    """An InternLM2 state dict: the packed wqkv (h_kv * (g + 2) * d rows)
    and the other tensors in their released names, bf16."""
    h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim)
    hid, ff = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    sd = {"model.tok_embeddings.weight": r(cfg.vocab_size, hid),
          "model.norm.weight": r(hid)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({p + "attention_norm.weight": r(hid),
                   p + "ffn_norm.weight": r(hid),
                   p + "attention.wqkv.weight": r((h + 2 * hk) * d, hid),
                   p + "attention.wo.weight": r(hid, h * d),
                   p + "feed_forward.w1.weight": r(ff, hid),
                   p + "feed_forward.w3.weight": r(ff, hid),
                   p + "feed_forward.w2.weight": r(hid, ff)})
    if untied:
        sd["output.weight"] = r(cfg.vocab_size, hid)
    return sd


@pytest.mark.parametrize("untied", [True, False], ids=["untied", "tied"])
def test_internlm2_plan_matches_jax_converter(untied):
    """The packed wqkv split into q, k and v by (h_kv, g + 2, d) groups at
    GQA 2:1, bit for bit JAX's ``internlm2_params_from_hf`` carried
    across by the bridge."""
    kw = dict(LLM_KW, attention_bias=False, tie_word_embeddings=not untied)
    tc, jc = tcfg.Qwen2Config(**kw), jcfg.Qwen2Config(**kw)
    sd = _internlm2_sd(tc, torch.Generator().manual_seed(6), untied)
    lm, rep = tload.internlm2_params_from_hf(sd.items(), tc, device="cpu")
    assert rep["tensors"] == len(sd) and rep["unread"] == []
    bridged = load_flax(Qwen2LM(tc), jtm.internlm2_params_from_hf(sd, jc))
    assert_same_params(lm, bridged)
    # the second kv group's first query head follows the first group's v
    d, g = tc.head_dim, tc.num_attention_heads // tc.num_key_value_heads
    w = sd["model.layers.0.attention.wqkv.weight"]
    got = lm.layers[0].q_proj.weight[g * d:(g + 1) * d]
    assert torch.equal(got, w[(g + 2) * d:(g + 3) * d])
    with pytest.raises(ValueError, match="attention_bias"):
        ttm.internlm2_plan(dataclasses.replace(tc, attention_bias=True))
