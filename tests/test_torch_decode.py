"""The port's LM decode side (x2i_torch/models/qwen2.py's KV cache,
models/decoding.py, Qwen2.5-VL's ``encode_with_answer``, the int8 LM)
against the JAX package's on the CPU: tiny float32 configs, JAX weights
carried across by the bridge, inputs from a numpy seed.

Tolerances: 2e-5 on the plain attention (one f32 softmax), 1e-4 through
the models (float32 summation order through a few layers, as
tests/test_torch_models.py); token ids and ``valid`` exactly. The int8
LM in float32: relative L2 at most 1e-3, the bar tests/test_torch_quant.py
holds the int8 FLUX to (an activation code flips where f32 sums in
another order cross a rounding boundary)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_params import one_thread, qwen2_tree, random_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.models import decoding as jdec
from x2i_tpu.models import qwen2_5_vl as jvl
from x2i_tpu.models.qwen2 import Qwen2LM as JQwen2
from x2i_tpu.ops import flash_attention as jfa
from x2i_tpu.ops import quant as jq
from x2i_tpu.ops.attention import attention as jattention
from x2i_torch.core import config as tcfg
from x2i_torch.models import decoding as tdec
from x2i_torch.models import qwen2_5_vl as tvl
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops.attention import attention
from x2i_torch.ops.quant import QuantLinear
from x2i_torch.params import load_flax

TOL = dict(atol=1e-4, rtol=1e-4)
OP_TOL = dict(atol=2e-5, rtol=2e-5)
QUANT_REL = 1e-3


def t(a, dtype=None):
    x = torch.from_numpy(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tree(seed, cfg):
    """``qwen2_tree`` with the untied head's leaves too (the prefill
    alone never reaches the head)."""
    if cfg.tie_word_embeddings:
        return qwen2_tree(seed, cfg)
    init = functools.partial(JQwen2(cfg).init,
                             method=lambda m, ids: m.logits(m(ids)[1]))
    return random_tree(init, jnp.zeros((1, 8), jnp.int32), seed=seed)


def _lm(seed=0, **kw):
    """(JAX LM, its tree with jnp leaves, the port's LM on the same
    weights), tiny f32 configs with the plain attention."""
    jc = jcfg.tiny_qwen2_config(use_pallas_attention=False, **kw)
    tree = _tree(seed, jc)
    model = load_flax(Qwen2LM(tcfg.tiny_qwen2_config(**kw)), tree)
    return JQwen2(jc), jax.tree_util.tree_map(jnp.asarray, tree), model


def _embeds(rng, b, s, h):
    return rng.standard_normal((b, s, h)).astype(np.float32)


def _mask(s, lengths):
    return np.arange(s)[None] < np.asarray(lengths)[:, None]


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("offset", [0, 5, 17])
def test_xla_attention_causal_offset_matches_jax(offset):
    """Query row r's causal diagonal at column offset + r, Sq < Skv, GQA
    4:2, a key mask; the dispatcher takes the plain route for any offset
    but 0 even when asked for the kernel."""
    rng = np.random.default_rng(offset)
    b, hq, hk, sq, skv, d = 2, 4, 2, 6, 24, 16
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, skv, d)).astype(np.float32)
    mask = _mask(skv, [skv, 20])
    want = jfa.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), causal=True,
                             causal_offset=offset)
    got = tfa.xla_attention(t(q), t(k), t(v), t(mask), causal=True,
                            causal_offset=offset)
    np.testing.assert_allclose(n(got), n(want), **OP_TOL)
    if offset:
        bshd = [a.transpose(0, 2, 1, 3) for a in (q, k, v)]
        routed = attention(*(t(a) for a in bshd), kv_mask=t(mask),
                           causal=True, implementation="kernel",
                           causal_offset=offset)
        jrouted = jattention(*(jnp.asarray(a) for a in bshd),
                             kv_mask=jnp.asarray(mask), causal=True,
                             implementation="pallas", causal_offset=offset)
        np.testing.assert_allclose(n(routed), n(jrouted), **OP_TOL)


# ------------------------------------------------------------- KV cache

def test_init_cache_shapes():
    jlm, tree, model = _lm()
    want = jlm.apply(tree, 3, 40, method=JQwen2.init_cache)
    got = model.init_cache(3, 40)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 3, 40, 2, 16)
        assert g.dtype == torch.float32 and not g.any()


def test_prefill_cached_matches_jax():
    """A right-padded batch of 2 into a 20-slot cache: the stacks, the
    logits of every position and the whole cache."""
    jlm, tree, model = _lm(1)
    rng = np.random.default_rng(1)
    emb, mask = _embeds(rng, 2, 12, 64), _mask(12, [12, 7])
    jcache = jlm.apply(tree, 2, 20, method=JQwen2.init_cache)
    want = jlm.apply(tree, jnp.asarray(emb), jnp.asarray(mask), jcache,
                     method=JQwen2.prefill_cached)
    got = model.prefill_cached(t(emb), t(mask), model.init_cache(2, 20))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    # the prompt's stack equals the cache-less prefill's
    with torch.inference_mode():
        plain, _ = model(inputs_embeds=t(emb), attention_mask=t(mask))
    np.testing.assert_allclose(n(got[0]), n(plain), **TOL)


def test_decode_step_mid_cache_matches_jax():
    """A prompt of 9 in a 24-slot cache, then one step written at slot 13
    (slots 9-12 empty and masked), at position 15."""
    jlm, tree, model = _lm(2)
    rng = np.random.default_rng(2)
    emb, mask = _embeds(rng, 2, 9, 64), _mask(9, [9, 6])
    tok = _embeds(rng, 2, 1, 64)
    kv = np.concatenate([mask, np.zeros((2, 15), bool)], -1)
    kv[:, 13] = True
    pos = np.full((2, 1), 15)
    jcache = jlm.apply(tree, 2, 24, method=JQwen2.init_cache)
    _, _, jcache = jlm.apply(tree, jnp.asarray(emb), jnp.asarray(mask),
                             jcache, method=JQwen2.prefill_cached)
    want = jlm.apply(tree, jnp.asarray(tok), jcache, 13, jnp.asarray(kv),
                     jnp.asarray(pos), method=JQwen2.decode_step)
    cache = model.prefill_cached(t(emb), t(mask), model.init_cache(2, 24))[2]
    got = model.decode_step(t(tok), cache, 13, t(kv), t(pos))
    assert tuple(got[0].shape) == (2, 3, 1, 64)
    assert tuple(got[1].shape) == (2, 1, 512)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(n(g), n(w), **TOL)


def test_prefill_chunk_at_an_offset_matches_jax():
    """A first chunk at slot 0, then a right-padded chunk of 6 at slot 7
    (row 1 holds 4 valid tokens): positions from the offset, keys of the
    earlier slots and the chunk's own valid ones."""
    jlm, tree, model = _lm(3)
    rng = np.random.default_rng(3)
    first, second = _embeds(rng, 2, 7, 64), _embeds(rng, 2, 6, 64)
    ones, chunk = np.ones((2, 7), bool), _mask(6, [6, 4])
    jcache = jlm.apply(tree, 2, 16, method=JQwen2.init_cache)
    _, _, jcache = jlm.apply(tree, jnp.asarray(first), jcache, 0,
                             jnp.asarray(ones), method=JQwen2.prefill_chunk)
    want = jlm.apply(tree, jnp.asarray(second), jcache, 7,
                     jnp.asarray(chunk), method=JQwen2.prefill_chunk)
    cache = model.prefill_chunk(t(first), model.init_cache(2, 16), 0,
                                t(ones))[2]
    got = model.prefill_chunk(t(second), cache, 7, t(chunk))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(n(g), n(w), **TOL)


# ---------------------------------------------------------- greedy decode

def _greedy(jlm, tree, model, emb, mask, steps, eos, step_pos0=None):
    want = jdec.greedy_decode_with_hiddens(
        jlm, tree, jnp.asarray(emb), jnp.asarray(mask), steps, eos,
        step_pos0=None if step_pos0 is None else jnp.asarray(step_pos0))
    got = tdec.greedy_decode_with_hiddens(
        model, t(emb), t(mask), steps, eos,
        step_pos0=None if step_pos0 is None else t(step_pos0))
    return got, want


@pytest.mark.parametrize("step_pos0", [None, (20, 31)])
def test_greedy_decode_with_hiddens_matches_jax(step_pos0):
    """8 steps from a right-padded batch of 2: tokens equal, ``valid``
    equal with an EOS that the JAX run emits mid-answer (row 0's first
    token from the third on that it had not emitted before), the
    prompt's and the steps' stacks within tolerance."""
    jlm, tree, model = _lm(4, tie_word_embeddings=False)
    rng = np.random.default_rng(4)
    emb, mask = _embeds(rng, 2, 10, 64), _mask(10, [10, 6])
    pos0 = None if step_pos0 is None else np.asarray(step_pos0)
    _, want = _greedy(jlm, tree, model, emb, mask, 8, -1, pos0)
    row = list(np.asarray(want[2])[0])
    at = next(j for j in range(2, 7) if row[j] not in row[:j])
    got, want = _greedy(jlm, tree, model, emb, mask, 8, int(row[at]), pos0)
    valid = np.asarray(want[3])
    assert valid[0, :at + 1].all() and not valid[0, at + 1:].any()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), valid)
    assert tuple(got[1].shape) == (2, 3, 8, 64)
    np.testing.assert_allclose(n(got[0]), n(want[0]), **TOL)
    np.testing.assert_allclose(n(got[1]), n(want[1]), **TOL)
    stack = tdec.concat_answer_hiddens(got[0], got[1])
    np.testing.assert_allclose(
        n(stack), n(jdec.concat_answer_hiddens(want[0], want[1])), **TOL)
    assert tuple(stack.shape) == (2, 3, 18, 64)


def test_encode_with_answer_under_mrope_matches_jax():
    """A prompt under 3-D positions whose streams differ (the M-RoPE
    sections of a tiny head), 6 answer tokens from max(pos3d) + 1."""
    jlm, tree, model = _lm(5, tie_word_embeddings=False)
    jc = jcfg.tiny_qwen2_config(use_pallas_attention=False,
                                tie_word_embeddings=False)
    rng = np.random.default_rng(5)
    s = 12
    ids = rng.integers(0, jc.vocab_size, (2, s))
    mask = _mask(s, [s, 9])
    ar = np.arange(s)
    pos3d = np.stack([ar, ar // 2 + 1, ar % 4 + 2])[:, None].repeat(2, 1)
    section = (2, 3, 3)
    encoder = jvl.Qwen2_5_VLEncoder(jvl.Qwen2_5_VLConfig(
        llm=jc, mrope_section=section))
    params = {"params": {"language_model": tree["params"]}}
    want = jvl.encode_with_answer(encoder, params, jnp.asarray(ids),
                                  jnp.asarray(mask), jnp.asarray(pos3d),
                                  None, max_new_tokens=6, eos_token_id=-1)
    cfg = tvl.Qwen2_5_VLConfig(llm=model.cfg, mrope_section=section)
    got = tvl.encode_with_answer(model, cfg, t(ids), t(mask), t(pos3d),
                                 max_new_tokens=6, eos_token_id=-1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert tuple(got[0].shape) == (2, 3, s + 6, 64)
    np.testing.assert_allclose(n(got[0]), n(want[0]), **TOL)
    # media need the tower (tests/test_torch_qwen_vision.py holds an
    # answer after an image against JAX)
    with pytest.raises(ValueError, match="vision tower"):
        tvl.encode_with_answer(model, cfg, t(ids), t(mask), t(pos3d),
                               vision_inputs={})


# ------------------------------------------------------------ int8 LM

def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_int8_lm_matches_jax(mode, tied):
    """The LM from a ``quantize_tree``'d JAX tree through the bridge: its
    dense layers (an untied head among them) QuantLinear, the table and a
    tied head float; the prefill's stack, and a 4-step greedy decode's
    tokens and stacks."""
    kw = dict(tie_word_embeddings=tied)
    jc = jcfg.tiny_qwen2_config(use_pallas_attention=False, quantized=mode,
                                **kw)
    tree = jq.quantize_tree(_tree(6, jcfg.tiny_qwen2_config(**kw)), mode)
    model = load_flax(Qwen2LM(tcfg.tiny_qwen2_config(quantized=mode, **kw)),
                      tree)
    assert isinstance(model.layers[1].down_proj, QuantLinear)
    assert isinstance(model.embed_tokens, torch.nn.Embedding)
    assert tied or isinstance(model.lm_head, QuantLinear)
    jlm, tree = JQwen2(jc), jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(6)
    ids, mask = rng.integers(0, 512, (2, 10)), _mask(10, [10, 7])
    want, _ = jlm.apply(tree, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        got, _ = model(t(ids), attention_mask=t(mask))
    assert _rel(n(got), n(want)) <= QUANT_REL
    emb = n(jlm.apply(tree, jnp.asarray(ids), method=JQwen2.embed))
    got, want = _greedy(jlm, tree, model, emb, mask, 4, -1)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert _rel(n(got[1]), n(want[1])) <= QUANT_REL


def test_quantize_module_takes_the_lm():
    """quantize_module_ on the float LM swaps its dense layers (not the
    table), sets its config's mode and keeps its quant_impl: the same
    buffers as the bridge from quantize_tree."""
    from x2i_torch.ops.quant import quantize_module_
    tree = qwen2_tree(7)
    model = load_flax(Qwen2LM(tcfg.tiny_qwen2_config(quant_impl="plain")),
                      tree)
    quantize_module_(model, "w8a8")
    assert model.cfg.quantized == "w8a8"
    assert model.layers[0].cfg.quantized == "w8a8"
    layers = [m for m in model.modules() if isinstance(m, QuantLinear)]
    assert len(layers) == 14 and all(m.impl == "plain" for m in layers)
    ref = load_flax(Qwen2LM(tcfg.tiny_qwen2_config(quantized="w8a8")),
                    jq.quantize_tree(tree, "w8a8"))
    want = dict(ref.named_buffers())
    for k, v in model.named_buffers():
        assert torch.equal(v, want[k]), k
