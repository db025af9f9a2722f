"""MiniCPM-o's speech half in the port (x2i_torch/models/chattts.py,
streaming.TTSPipeline, the TTS plans) against the JAX package, on the CPU.

The same flax trees (``random_tree``, numpy from a seed) go through the
bridge into the port's modules; the same numpy inputs go through both.
Sizes: the tiny ChatTTS of tests/test_streaming.py (hidden 64, 2 layers,
50 audio tokens, 4 codebooks, 16 reserved text slots, top-k 5, top-p
0.9), a tiny vocoder (dim 32, 1 layer, n_fft 64, hop 16) and the full
DVAE, which is small.

Bars, f32 on both sides: the ConvNeXt block, the DVAE decoder, the DVAE
and the vocoder within 1e-5 of the largest magnitude of JAX's output at
the worst element; FSQ indices, the codes of the lattice and the
generation mask exactly; logits within 1e-4 of the largest magnitude;
``generate`` and ``speak`` on JAX's own Gumbel draws (its key chain
repeated: ``jax.random.categorical`` is the argmax of the logits plus
``jax.random.gumbel`` of their shape) give JAX's codes and ``n`` exactly,
and ``speak``'s waveform is within 1e-4 of the largest magnitude."""

import functools
import inspect
import subprocess
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_params import one_thread, random_tree
from x2i_tpu.convert.torch_models import (chattts_params_from_reference,
                                          dvae_params_from_reference)
from x2i_tpu.models import chattts as J
from x2i_tpu.streaming import TTSPipeline as JTTSPipeline
from x2i_torch.convert.load import load_tts
from x2i_torch.models import chattts as T
from x2i_torch.params import load_flax
from x2i_torch.streaming import TTSPipeline

TINY = dict(llm_dim=32, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_hidden_layers=2, num_audio_tokens=50,
            num_text_tokens=120, num_vq=4, spk_emb_token_id=100,
            audio_bos_token_id=101, streaming_text_reserved_len=16,
            streaming_text_chunk_size=4, streaming_audio_chunk_size=6,
            top_k=5, top_p=0.9)
VOCODER = dict(input_channels=100, dim=32, intermediate_dim=64,
               num_layers=1, n_fft=64, hop_length=16)
BOS = 99                                  # the tiny tokenizer's bos id
REL = 1e-5                                # the codec's and vocoder's bar
LOGITS_REL, WAV_REL = 1e-4, 1e-4


def tokenize(text):
    return [ord(c) % 90 for c in text]


def close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def rng(seed):
    return np.random.default_rng(seed)


_JITTED = {}


def japply(module, method, *args, static=(), **kw):
    """``module.apply(*args, method=method, **kw)``, jitted once per module
    type, config and method: eager flax compiles each op apart, which took
    most of this file's time."""
    key = (type(module), getattr(module, "cfg", None), method, static)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(module.apply, method=method),
                               static_argnums=static)
    return _JITTED[key](*args, **kw)


class Jitted:
    """A flax module whose ``apply`` goes through ``japply``, for JAX's
    ``TTSPipeline``, which calls ``apply`` (``generate``'s step count, its
    sixth argument after the params, is static)."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        return getattr(self.module, name)

    def apply(self, params, *args, method=None, **kw):
        static = (6,) if getattr(method, "__name__", "") == "generate" else ()
        return japply(self.module, method, params, *args, static=static,
                      **kw)


def emb_text(module, ids):
    return module.emb_text(ids)


# ------------------------------------------------------------ the codec

def test_convnext_block_matches_jax():
    x = rng(0).standard_normal((2, 20, 16)).astype(np.float32)
    jm = J.ConvNeXt1DBlock(16, 64, 7, 2)
    tree = random_tree(jm.init, jnp.asarray(x))
    tm = load_flax(T.ConvNeXt1DBlock(16, 64, 7, 2), tree)
    got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    close(got, japply(jm, None, jtree(tree), jnp.asarray(x)), REL)


def test_dvae_decoder_matches_jax():
    x = rng(1).standard_normal((1, 14, 12)).astype(np.float32)
    kw = dict(n_layer=2, bn_dim=8, hidden=16)
    jm = J.DVAEDecoder(12, 10, **kw)
    tree = random_tree(jm.init, jnp.asarray(x))
    tm = load_flax(T.DVAEDecoder(12, 10, **kw), tree)
    got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    close(got, japply(jm, None, jtree(tree), jnp.asarray(x)), REL)


def test_fsq_matches_jax():
    """Index -> codes -> index is the identity on the whole lattice, in
    both packages alike; quantize lands on JAX's lattice points."""
    levels = (5, 5, 5, 5)
    idx = np.arange(625)
    codes = T.fsq_indices_to_codes(torch.from_numpy(idx), levels)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(J.fsq_indices_to_codes(
            jnp.asarray(idx), levels)))
    np.testing.assert_array_equal(
        T.fsq_codes_to_indices(codes, levels).numpy(), idx)
    z = 2.0 * rng(2).standard_normal((64, 4)).astype(np.float32)
    q = T.fsq_quantize(torch.from_numpy(z), levels)
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(J.fsq_quantize(jnp.asarray(z), levels)))
    np.testing.assert_array_equal(
        T.fsq_codes_to_indices(q, levels).numpy(),
        np.asarray(J.fsq_codes_to_indices(jnp.asarray(q.numpy()), levels)))


@pytest.fixture(scope="module")
def dvae():
    """(JAX DVAE, its tree, the port's DVAE)."""
    jm = J.DVAE()
    tree = random_tree(lambda k, m: jm.init(k, m, method=J.DVAE.encode_decode),
                       jnp.zeros((1, 8, 100)), seed=3)
    return jm, tree, load_flax(T.DVAE(), tree)


def test_dvae_encode_and_decode_match_jax(dvae):
    """The indices of a mel exactly; the mel of the indices (T codes,
    2T frames) to the bar."""
    jm, tree, tm = dvae
    mel = (0.5 * rng(4).standard_normal((1, 16, 100)) + 1.0).astype(
        np.float32)
    want = np.asarray(japply(jm, J.DVAE.encode, jtree(tree),
                             jnp.asarray(mel)))
    got = tm.encode(torch.from_numpy(mel))
    assert got.shape == (1, 8, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    codes = rng(5).integers(0, 625, (1, 8, 4))
    out = tm.decode(torch.from_numpy(codes))
    assert out.shape == (1, 16, 100)
    close(out, japply(jm, J.DVAE.decode, jtree(tree), jnp.asarray(codes)),
          REL)


def test_vocoder_matches_jax():
    mel = rng(6).standard_normal((2, 12, 100)).astype(np.float32)
    jm = J.VocosVocoder(**VOCODER)
    tree = random_tree(jm.init, jnp.asarray(mel), seed=7)
    tm = load_flax(T.VocosVocoder(**VOCODER), tree)
    got = tm(torch.from_numpy(mel))
    assert got.shape == (2, 11 * 16)
    close(got, japply(jm, None, jtree(tree), jnp.asarray(mel)), REL)


# ------------------------------------------------------------ the GPT

@pytest.mark.parametrize("past,seq_end", [(5, None), (18, None), (19, None),
                                          (24, None), (26, 29), (40, None)])
def test_generation_kv_mask_matches_jax(past, seq_end):
    cfg_j, cfg_t = J.ChatTTSConfig(**TINY), T.ChatTTSConfig(**TINY)
    text = np.arange(16) < 9
    kv = cfg_j.condition_length + 24
    want = J.make_generation_kv_mask(
        cfg_j, jnp.asarray(text), kv, jnp.asarray(past),
        None if seq_end is None else jnp.asarray(seq_end))
    got = T.make_generation_kv_mask(cfg_t, torch.from_numpy(text), kv, past,
                                    seq_end)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def tts_tree(cfg, seed=8):
    """A random tree of JAX's tiny ConditionalChatTTS, its heads' v drawn
    at the fan-in's scale (``random_tree`` gives raw leaves 1 + N(0, 0.1),
    which would give every code nearly the same logit)."""
    jm = J.ConditionalChatTTS(cfg)
    ids = jnp.full((1, 2 + cfg.streaming_text_reserved_len), 3)
    tree = random_tree(
        lambda k, *a: jm.init({"params": k}, *a,
                              method=J.ConditionalChatTTS.init_all),
        ids, jnp.arange(ids.shape[1])[None],
        jm.init_cache(cfg.condition_length + 4),
        jnp.zeros((1, 1, cfg.llm_dim)),
        jnp.zeros((1, 1, cfg.num_vq), jnp.int32),
        jnp.ones((cfg.streaming_text_reserved_len,), bool), seed=seed)
    r = rng(seed + 1)
    for i in range(cfg.num_vq):
        tree["params"][f"head_v_{i}"] = (r.standard_normal(
            (cfg.hidden_size, cfg.num_audio_tokens)) / 8.0).astype(np.float32)
    return jm, tree


@pytest.fixture(scope="module")
def tts():
    """(JAX model, its tree, the port's model) at the tiny config."""
    jm, tree = tts_tree(J.ChatTTSConfig(**TINY))
    return jm, tree, load_flax(T.ConditionalChatTTS(T.ChatTTSConfig(**TINY)),
                               tree)


def text_prefill(cfg, n_text=9, seed=10):
    """The [bos][spk][text][pad] ids, positions, text mask and spk hidden
    that ``speak`` builds, as numpy."""
    r = rng(seed)
    reserved = cfg.streaming_text_reserved_len
    ids = np.zeros((1, 2 + reserved), np.int64)
    ids[0, 0], ids[0, 1] = BOS, cfg.spk_emb_token_id
    ids[0, 2:2 + n_text] = r.integers(0, 90, n_text)
    spk = r.standard_normal((1, 1, cfg.llm_dim)).astype(np.float32)
    return (ids, np.arange(ids.shape[1])[None], np.arange(reserved) < n_text,
            spk)


def jax_prefill(jm, p, ids, pos, spk, max_len):
    return japply(jm, J.ConditionalChatTTS.prefill_text, p, jnp.asarray(ids),
                  jnp.asarray(pos), jm.init_cache(max_len), jnp.asarray(spk))


def jax_bos_step(jm, p, cache, text):
    """JAX's logits of the audio-bos step after the text prefill."""
    bos = japply(jm, emb_text, p,
                 jnp.full((1, 1), jm.cfg.audio_bos_token_id))
    logits, _ = japply(jm, J.ConditionalChatTTS.decode_step, p, bos, cache,
                       jnp.asarray(jm.cfg.condition_length - 1),
                       jnp.asarray(text))
    return logits


def jax_gumbel(seed, steps, cfg):
    """JAX's draws in ``generate``: the key split once a step, the
    categorical's Gumbel of the logits' (num_vq, V) shape."""
    key, out = jax.random.key(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(jax.random.gumbel(sub, (cfg.num_vq, cfg.num_audio_tokens),
                                     jnp.float32))
    return jax.random.key(seed), np.stack([np.asarray(g) for g in out])


def test_prefill_and_decode_step_logits_match_jax(tts):
    """prefill_text, then the audio-bos step, then a teacher-forced
    prefill_audio of three codes and the step after it."""
    jm, tree, tm = tts
    cfg = jm.cfg
    ids, pos, text, spk = text_prefill(cfg)
    max_len = cfg.condition_length + 8
    p = jtree(tree)
    jcache = jax_prefill(jm, p, ids, pos, spk, max_len)
    tcache = tm.prefill_text(torch.from_numpy(ids), torch.from_numpy(pos),
                             tm.init_cache(max_len), torch.from_numpy(spk))
    k = cfg.num_hidden_layers
    close(tcache[0][:k, :, :ids.shape[1]],
          np.asarray(jcache[0])[:, :, :ids.shape[1]], LOGITS_REL)
    want = jax_bos_step(jm, p, jcache, text)
    idx = cfg.condition_length - 1
    bos_t = tm.emb_text(torch.full((1, 1), cfg.audio_bos_token_id))
    got, _ = tm.decode_step(bos_t, tcache, idx, torch.from_numpy(text))
    close(got, want, LOGITS_REL)

    codes = rng(11).integers(0, cfg.num_audio_tokens, (1, 3, cfg.num_vq))
    jcache = japply(jm, J.ConditionalChatTTS.prefill_audio, p,
                    jnp.asarray(codes), jcache, jnp.asarray(idx),
                    jnp.asarray(text))
    tcache = tm.prefill_audio(torch.from_numpy(codes), tcache, idx,
                              torch.from_numpy(text))
    nxt = japply(jm, J.ConditionalChatTTS.embed_code, p,
                 jnp.asarray(codes[:, -1:]))
    want, _ = japply(jm, J.ConditionalChatTTS.decode_step, p, nxt, jcache,
                     jnp.asarray(idx + 4), jnp.asarray(text))
    got, _ = tm.decode_step(tm.embed_code(torch.from_numpy(codes[:, -1:])),
                            tcache, idx + 4, torch.from_numpy(text))
    close(got, want, LOGITS_REL)


GENERATE = {"plain": {}, "penalty": {"repetition_penalty": 1.3},
            "top_p_1": {"top_p": 1.0, "top_k": 50}}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_jax(case):
    """The same codes and the same n on JAX's draws: the penalty off and
    on, and a top-p of 1.0 (the cut's index past the end: nothing cut)."""
    cfg_kw = dict(TINY, **GENERATE[case])
    jm, tree = tts_tree(J.ChatTTSConfig(**cfg_kw))
    tm = load_flax(T.ConditionalChatTTS(T.ChatTTSConfig(**cfg_kw)), tree)
    cfg, steps = jm.cfg, 24
    ids, pos, text, spk = text_prefill(cfg)
    max_len = cfg.condition_length + steps
    p = jtree(tree)
    key, gumbel = jax_gumbel(12, steps, cfg)
    jcache = jax_prefill(jm, p, ids, pos, spk, max_len)
    want, _, n, _ = japply(
        jm, J.ConditionalChatTTS.generate, p,
        jnp.zeros((1, steps, cfg.num_vq), jnp.int32), jcache,
        jnp.asarray(cfg.condition_length - 1), jnp.asarray(text), key, steps,
        static=(6,))
    tcache = tm.prefill_text(torch.from_numpy(ids), torch.from_numpy(pos),
                             tm.init_cache(max_len), torch.from_numpy(spk))
    got, _, tn, _ = tm.generate(
        torch.zeros((1, steps, cfg.num_vq), dtype=torch.int64), tcache,
        cfg.condition_length - 1, torch.from_numpy(text),
        torch.from_numpy(gumbel), steps)
    assert tn == int(n)
    np.testing.assert_array_equal(got[0, :tn].numpy(),
                                  np.asarray(want)[0, :tn])


def jax_filter(cfg, min_new_tokens, temperature):
    """JAX's ``sample_heads`` (the closure ``generate`` builds) with its
    draw taken out: called under a patched ``jax.random.categorical`` that
    hands back the logits it was given, it returns the filtered logits."""
    gen = inspect.unwrap(J.ConditionalChatTTS.generate)
    code = next(c for c in gen.__code__.co_consts
                if getattr(c, "co_name", "") == "sample_heads")
    cells = {"cfg": cfg, "eos": cfg.num_audio_tokens - 1,
             "min_new_tokens": min_new_tokens, "temperature": temperature}
    fn = types.FunctionType(code, gen.__globals__, "sample_heads", None,
                            tuple(types.CellType(cells[n])
                                  for n in code.co_freevars))

    def filtered(logits, window, valid, step):
        with mock.patch.object(jax.random, "categorical",
                               lambda key, l, axis=-1: l):
            return np.asarray(fn(jnp.asarray(logits), jnp.asarray(window),
                                 jnp.asarray(valid), jax.random.key(0),
                                 step))
    return filtered


FILTERS = {"penalty": dict(repetition_penalty=1.3),
           "top_p_1": dict(top_p=1.0, top_k=50),
           "top_p_past_the_end": dict(top_p=2.0, top_k=50),
           "ties": dict(top_k=3)}


@pytest.mark.parametrize("case", list(FILTERS))
@pytest.mark.parametrize("step", [9, 10])
def test_filter_logits_matches_jax(case, step):
    """``filter_logits`` against JAX's own filter on the same logits and
    window: the repetition penalty's power of the count (the top code
    four times, some window slots not yet valid), eos masked before
    ``min_new_tokens`` (10), top-k with ties at the k-th value, and top-p
    at 1.0 and past the end (JAX's take_along_axis gives NaN there and
    cuts nothing)."""
    cfg_kw = dict(TINY, **FILTERS[case])
    jcfg, tcfg = J.ChatTTSConfig(**cfg_kw), T.ChatTTSConfig(**cfg_kw)
    r = rng(19 + step)
    logits = (2 * r.standard_normal((1, 50, 4))).astype(np.float32)
    if case == "ties":
        logits[0, :8] = logits[0, 0]           # the top values tied
        logits[0, 0] += 10.0
    window = r.integers(0, 50, (4, 16))
    window[:, :4] = logits[0].argmax(0)[:, None]   # the top code four times
    valid = np.arange(16) < 13
    want = jax_filter(jcfg, 10, 0.8)(logits, window, valid, step)
    model = T.ConditionalChatTTS(tcfg, device="meta")
    got = model.filter_logits(torch.from_numpy(logits),
                              torch.from_numpy(window),
                              torch.from_numpy(valid).float(), step, 10,
                              0.8).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    assert keep.any(-1).all()
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)


def test_generate_takes_a_generator(tts):
    """Draws from a ``torch.Generator``: codes in range, the same codes
    for the same seed."""
    _, _, tm = tts
    cfg = tm.cfg
    ids, pos, text, spk = text_prefill(cfg)
    runs = []
    for _ in range(2):
        cache = tm.prefill_text(torch.from_numpy(ids), torch.from_numpy(pos),
                                tm.init_cache(cfg.condition_length + 12),
                                torch.from_numpy(spk))
        codes, _, n, _ = tm.generate(
            torch.zeros((1, 12, cfg.num_vq), dtype=torch.int64), cache,
            cfg.condition_length - 1, torch.from_numpy(text),
            torch.Generator().manual_seed(5), 12)
        runs.append((codes, n))
    assert runs[0][1] == runs[1][1] >= 1
    assert torch.equal(runs[0][0], runs[1][0])
    assert 0 <= int(runs[0][0].min()) and int(runs[0][0].max()) < 50


def test_speak_matches_jax(tts, dvae):
    """``TTSPipeline.speak`` end to end: the text's numbers spelled out,
    tokenized, prefilled; JAX's codes and n on its draws; the DVAE's and
    the vocoder's waveform to the bar."""
    jm, tree, tm = tts
    jd, dtree, td = dvae
    mel = jnp.zeros((1, 8, 100))
    jv = J.VocosVocoder(**VOCODER)
    vtree = random_tree(jv.init, mel, seed=13)
    tv = load_flax(T.VocosVocoder(**VOCODER), vtree)
    cfg, steps = jm.cfg, 20
    spk = rng(14).standard_normal((1, 1, cfg.llm_dim)).astype(np.float32)
    key, gumbel = jax_gumbel(15, steps, cfg)
    text = "call me at 42 past 7"
    jpipe = JTTSPipeline(Jitted(jm), jtree(tree), Jitted(jd), jtree(dtree),
                         Jitted(jv), jtree(vtree), tokenize,
                         bos_token_id=BOS)
    wav, codes, n = jpipe.speak(text, jnp.asarray(spk), key,
                                max_audio_tokens=steps)
    pipe = TTSPipeline(tm, td, tv, tokenize, bos_token_id=BOS)
    twav, tcodes, tn = pipe.speak(text, torch.from_numpy(spk),
                                  torch.from_numpy(gumbel),
                                  max_audio_tokens=steps)
    assert tn == n and tcodes.shape == (1, n, cfg.num_vq)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    close(twav, wav, WAV_REL)
    assert twav.shape == (1, (2 * n - 1) * VOCODER["hop_length"])


def test_tts_pipeline_export_is_lazy():
    """``x2i_torch.TTSPipeline`` resolves on first use; importing
    ``x2i_torch`` imports no model module."""
    code = ("import sys, x2i_torch; "
            "assert 'x2i_torch.models.chattts' not in sys.modules; "
            "assert 'x2i_torch.streaming' not in sys.modules; "
            "from x2i_torch.streaming import TTSPipeline; "
            "assert x2i_torch.TTSPipeline is TTSPipeline")
    subprocess.run([sys.executable, "-c", code], check=True)


# ------------------------------------------------------------ checkpoints

def reference_sd(cfg, r, wn_layout, vq=True):
    """A state dict in the reference's layout: the ChatTTS keys under
    ``tts.`` (the weight-normed heads in ``wn_layout``, "parametrizations"
    or "weight_g"; the projector in the config's ``use_mlp`` form) and the
    DVAE's under ``tts.dvae.`` (``vq``: with its FSQ projections)."""
    def w(*s):
        return (0.05 * r.standard_normal(s)).astype(np.float32)

    h, inter, v = cfg.hidden_size, cfg.intermediate_size, \
        cfg.num_audio_tokens
    sd = {"tts.emb_text.weight": w(cfg.num_text_tokens, h),
          "tts.model.norm.weight": 1 + w(h)}
    if cfg.use_mlp:
        sd.update({"tts.projector.linear1.weight": w(h, cfg.llm_dim),
                   "tts.projector.linear1.bias": w(h),
                   "tts.projector.linear2.weight": w(h, h),
                   "tts.projector.linear2.bias": w(h)})
    else:
        sd["tts.projector.weight"] = w(h, cfg.llm_dim)
    for i in range(cfg.num_vq):
        sd[f"tts.emb_code.{i}.weight"] = w(v, h)
        g, vv = (("parametrizations.weight.original0",
                  "parametrizations.weight.original1")
                 if wn_layout == "parametrizations"
                 else ("weight_g", "weight_v"))
        sd[f"tts.head_code.{i}.{g}"] = 1 + w(v, 1)
        sd[f"tts.head_code.{i}.{vv}"] = 20 * w(v, h)
    for layer in range(cfg.num_hidden_layers):
        p = f"tts.model.layers.{layer}."
        sd[p + "input_layernorm.weight"] = 1 + w(h)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(h)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + f"self_attn.{n}.weight"] = 4 * w(h, h)
        sd[p + "mlp.gate_proj.weight"] = 4 * w(inter, h)
        sd[p + "mlp.up_proj.weight"] = 4 * w(inter, h)
        sd[p + "mlp.down_proj.weight"] = 4 * w(h, inter)
    sd.update({"tts.dvae.coef": 1 + w(1, 100, 1),
               "tts.dvae.downsample_conv.0.weight": w(512, 100, 3),
               "tts.dvae.downsample_conv.0.bias": w(512),
               "tts.dvae.downsample_conv.2.weight": w(512, 512, 4),
               "tts.dvae.downsample_conv.2.bias": w(512),
               "tts.dvae.out_conv.weight": w(100, 512, 3)})
    for name, odim in (("encoder", 1024), ("decoder", 512)):
        p = f"tts.dvae.{name}."
        sd.update({p + "conv_in.0.weight": w(128, 512, 3),
                   p + "conv_in.0.bias": w(128),
                   p + "conv_in.2.weight": w(256, 128, 3),
                   p + "conv_in.2.bias": w(256),
                   p + "conv_out.weight": w(odim, 256, 1)})
        for i in range(12):
            b = p + f"decoder_block.{i}."
            sd.update({b + "dwconv.weight": w(256, 1, 7),
                       b + "dwconv.bias": w(256),
                       b + "norm.weight": 1 + w(256), b + "norm.bias": w(256),
                       b + "pwconv1.weight": w(1024, 256),
                       b + "pwconv1.bias": w(1024),
                       b + "pwconv2.weight": w(256, 1024),
                       b + "pwconv2.bias": w(256), b + "coef": w(256)})
    if vq:
        for g in (0, 1):
            b = f"tts.dvae.vq_layer.quantizer.rvqs.{g}."
            sd.update({b + "project_in.weight": 20 * w(4, 512),
                       b + "project_in.bias": w(4),
                       b + "project_out.weight": 20 * w(512, 4),
                       b + "project_out.bias": w(512)})
    return sd


def write_dir(path, sd, extra=()):
    """A MiniCPM-o-like directory: the speech keys beside an LM tensor,
    in two shards."""
    from safetensors.numpy import save_file
    keys = sorted(sd)
    half = len(keys) // 2
    save_file({k: sd[k] for k in keys[:half]},
              str(path / "model-00001-of-00002.safetensors"))
    rest = {k: sd[k] for k in keys[half:]}
    rest["llm.model.norm.weight"] = np.ones(8, np.float32)
    rest.update({k: np.zeros(2, np.float32) for k in extra})
    save_file(rest, str(path / "model-00002-of-00002.safetensors"))
    return str(path)


def load_fixture(path, layout, use_mlp, seed=16):
    """(JAX config, the reference state dict, the port's ChatTTS and DVAE
    loaded by ``load_tts`` from a fixture directory of it)."""
    kw = dict(TINY, use_mlp=use_mlp)
    jcfg = J.ChatTTSConfig(**kw)
    sd = reference_sd(jcfg, rng(seed), layout)
    tm, td = load_tts(write_dir(path, sd), T.ChatTTSConfig(**kw),
                      device="cpu")
    return jcfg, sd, tm, td


@pytest.mark.parametrize("layout,use_mlp", [("parametrizations", True),
                                            ("weight_g", False)])
def test_chattts_plan_matches_the_jax_converter(tmp_path, layout, use_mlp):
    """A fixture directory's ``tts.`` keys (the heads in either weight-norm
    layout, the projector in either form) through ``load_tts`` compute
    what JAX's ``chattts_params_from_reference`` and module compute: the
    logits of the text prefill and the audio-bos step."""
    jcfg, sd, tm, _ = load_fixture(tmp_path, layout, use_mlp)
    assert tm.load_report["unread"] == []
    p = {"params": jtree(chattts_params_from_reference(sd, jcfg))}
    jm = J.ConditionalChatTTS(jcfg)
    ids, pos, text, spk = text_prefill(jcfg)
    max_len = jcfg.condition_length + 2
    want = jax_bos_step(jm, p, jax_prefill(jm, p, ids, pos, spk, max_len),
                        text)
    idx = jcfg.condition_length - 1
    tcache = tm.prefill_text(torch.from_numpy(ids), torch.from_numpy(pos),
                             tm.init_cache(max_len), torch.from_numpy(spk))
    got, _ = tm.decode_step(
        tm.emb_text(torch.full((1, 1), jcfg.audio_bos_token_id)), tcache,
        idx, torch.from_numpy(text))
    close(got, want, LOGITS_REL)


def test_dvae_plan_matches_the_jax_converter(tmp_path):
    """The fixture's ``tts.dvae.`` keys through ``load_tts``: the DVAE's
    indices of a mel exactly and its mel of them to the bar, against
    JAX's ``dvae_params_from_reference`` and DVAE."""
    _, sd, _, td = load_fixture(tmp_path, "weight_g", True)
    assert td.vq is not None and td.load_report["unread"] == []
    dp = {"params": jtree(dvae_params_from_reference(sd, "tts.dvae."))}
    mel = (0.5 * rng(17).standard_normal((1, 16, 100)) + 1.0).astype(
        np.float32)
    codes = np.asarray(japply(J.DVAE(), J.DVAE.encode, dp,
                              jnp.asarray(mel)))
    np.testing.assert_array_equal(td.encode(torch.from_numpy(mel)).numpy(),
                                  codes)
    close(td.decode(torch.from_numpy(codes.copy())),
          japply(J.DVAE(), J.DVAE.decode, dp, jnp.asarray(codes)), REL)


def test_tts_plans_are_strict(tmp_path):
    """A ``tts.`` key neither plan names raises, in the GPT's and in the
    DVAE's part; a directory without the DVAE's ``vq_layer`` (which JAX's
    converter skips) loads a DVAE without its quantizer, whose decode
    raises; the Llama's own token table is left unread."""
    cfg = J.ChatTTSConfig(**TINY)
    sd = reference_sd(cfg, rng(18), "weight_g", vq=False)
    tcfg = T.ChatTTSConfig(**TINY)
    for i, bad in enumerate(("tts.extra.weight",
                             "tts.dvae.vq_layer.extra")):
        d = tmp_path / str(i)
        d.mkdir()
        with pytest.raises(KeyError, match="not a tensor"):
            load_tts(write_dir(d, sd, [bad]), tcfg, device="cpu")
    d = tmp_path / "ok"
    d.mkdir()
    tm, td = load_tts(write_dir(d, sd, ["tts.model.embed_tokens.weight"]),
                      tcfg, device="cpu")
    assert tm.load_report["unread"] == ["tts.model.embed_tokens.weight"]
    assert td.vq is None
    with pytest.raises(ValueError, match="quantizer"):
        td.decode(torch.zeros((1, 2, 4), dtype=torch.int64))
