"""The port's teacher text encoders (T5 v1.1 and the CLIP text tower)
against the JAX package's on the CPU, in float32 at tiny sizes, on the
same weights carried across by the bridge (the scan-stacked ``block``
trees, T5's ``rel_bias`` and ``shared`` table, CLIP's position table) and
the same numpy ids. Tolerance: 1e-4 absolute and relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_params import random_tree
from x2i_tpu.models import clip as jclip
from x2i_tpu.models import t5 as jt5
from x2i_torch.core import config as tcfg
from x2i_torch.models import clip as tclip
from x2i_torch.models import t5 as tt5
from x2i_torch.params import load_flax

TOL = dict(atol=1e-4, rtol=1e-4)

T5_KW = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_heads=4)
CLIP_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               max_position_embeddings=16, eos_token_id=63)


def _t5():
    jc = jt5.T5Config(dtype=jnp.float32, param_dtype=jnp.float32, **T5_KW)
    tree = random_tree(jt5.T5Encoder(jc).init, jnp.zeros((1, 8), jnp.int32))
    return jc, tcfg.T5Config(dtype=torch.float32, **T5_KW), tree


def _clip():
    jc = jclip.CLIPTextConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                              **CLIP_KW)
    tree = random_tree(jclip.CLIPTextEncoder(jc).init,
                       jnp.zeros((1, 12), jnp.int32), seed=1)
    return jc, tcfg.CLIPTextConfig(dtype=torch.float32, **CLIP_KW), tree


def test_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 5)[:, None]
    for buckets, dist in ((32, 128), (16, 20)):
        np.testing.assert_array_equal(
            tt5.relative_position_bucket(torch.as_tensor(rel), buckets,
                                         dist).numpy(),
            np.asarray(jt5.relative_position_bucket(jnp.asarray(rel),
                                                    buckets, dist)))


def test_t5_encoder_matches_jax():
    """Right-padded masks (one row full, one cut at 7 of 12 tokens); the
    shared bucketed bias rides the plain attention with no 1/sqrt(d)."""
    jc, tc, tree = _t5()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 12))
    mask = np.arange(12)[None] < np.array([[12], [7]])
    want = jt5.T5Encoder(jc).apply(tree, jnp.asarray(ids), jnp.asarray(mask))
    model = load_flax(tt5.T5Encoder(tc), tree)
    with torch.no_grad():
        got = model(torch.as_tensor(ids), torch.as_tensor(mask))
    assert got.shape == (2, 12, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_clip_text_encoder_matches_jax(masked):
    """Causal attention with an optional kv mask; pooled at the first EOS
    (two in row 0, none in row 1: position 0)."""
    jc, tc, tree = _clip()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 63, (2, 12))
    ids[0, 5] = ids[0, 9] = 63
    mask = np.arange(12)[None] < np.array([[12], [8]]) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want = jclip.CLIPTextEncoder(jc).apply(tree, jnp.asarray(ids), jm)
    model = load_flax(tclip.CLIPTextEncoder(tc), tree)
    with torch.no_grad():
        got = model(torch.as_tensor(ids),
                    None if mask is None else torch.as_tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got[1][0].numpy(), got[0][0, 5].numpy())


def test_bridge_refuses_teacher_trees_that_do_not_fit():
    _, tc, tree = _t5()
    params = tree["params"]
    extra = {**params, "lm_head": {"kernel": np.zeros((32, 64))}}
    with pytest.raises(KeyError, match="lm_head"):
        load_flax(tt5.T5Encoder(tc), extra)
    enc = {k: v for k, v in params["encoder"].items() if k != "rel_bias"}
    with pytest.raises(KeyError, match="rel_bias"):
        load_flax(tt5.T5Encoder(tc), {**params, "encoder": enc})
    _, cc, ctree = _clip()
    cparams = {k: v for k, v in ctree["params"].items()
               if k != "position_embedding"}
    with pytest.raises(KeyError, match="position_embedding"):
        load_flax(tclip.CLIPTextEncoder(cc), cparams)
