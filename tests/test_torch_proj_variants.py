"""The proj's legacy variants (``x2i_torch/models/proj_variants.py``) and
the proj's T5 refiner (``Proj(use_t5=True)``) against the JAX package's on
the CPU: the same random param tree through the bridge, the same numpy
input, outputs within 1e-4 in float32 (the models' bar); the proj plan
refusing a checkpoint with refiner keys, and ``streaming_mix_spec``
refusing the refiner, as JAX does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import n, t
from test_torch_params import random_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.models import proj_variants as jpv
from x2i_tpu.models.proj import Proj as JProj
from x2i_torch.convert.torch_models import proj_plan
from x2i_torch.core import config as tcfg
from x2i_torch.models import proj_variants as tpv
from x2i_torch.models.proj import Proj, streaming_mix_spec
from x2i_torch.params import load_flax, to_flax

TOL = dict(atol=1e-4, rtol=1e-4)


def _check(jmod, tmod, x, seed=0):
    tree = random_tree(jmod.init, jnp.zeros(x.shape, jnp.float32), seed=seed)
    want = jax.jit(jmod.apply)(tree, jnp.asarray(x, jnp.float32))
    ported = load_flax(tmod, tree)
    with torch.inference_mode():
        got = ported(t(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(n(g), n(w), **TOL)
    return ported, tree


@pytest.mark.parametrize("depth,deep", [(3, False), (3, True), (6, False)],
                         ids=["mlp", "mlp2", "mlp_plus"])
def test_mlp_proj_matches_jax(depth, deep):
    x = np.random.default_rng(1).standard_normal((2, 5, 16))
    _check(jpv.MLPProj(in_dim=16, out_dim=24, out_dim1=8, depth=depth,
                       deep_pooled_head=deep),
           tpv.MLPProj(16, 24, 8, depth=depth, deep_pooled_head=deep), x)


def test_transformer_proj_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 16))
    _check(jpv.TransformerProj(d_model=16, n_heads=4, out_dim1=8,
                               out_dim2=24, num_layers=2, ffn_dim=32),
           tpv.TransformerProj(16, 4, 8, 24, num_layers=2, ffn_dim=32), x)


@pytest.mark.parametrize("variant", ["proj", "proj2", "proj3"])
def test_legacy_proj_matches_jax(variant):
    kw = dict(in_channels=3, input_dim=16, output_dim0=8, output_dim1=24,
              num_layers=2, num_heads=2, head_dim=8)
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 16))
    _check(jpv.LegacyProj(jpv.LegacyProjConfig(**kw), variant=variant),
           tpv.LegacyProj(tpv.LegacyProjConfig(**kw), variant=variant), x)


def _t5_cfgs(mode):
    kw = dict(in_channels=3, input_dim=16, output_dim0=8, output_dim1=12,
              num_layers=2, num_heads=2, head_dim=8, use_t5=True,
              use_scale=mode == "scale", use_cnn=mode == "cnn")
    return (jcfg.ProjConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            tcfg.ProjConfig(dtype=torch.float32, **kw))


@pytest.mark.parametrize("mode", ["scale", "cnn", "mean"])
def test_proj_t5_refiner_matches_jax(mode):
    """The refiner over each of the C channels, (B * C, S, H), then each
    mixing mode and the MLP; the round trip through ``to_flax`` gives the
    same tree back."""
    jc, tc = _t5_cfgs(mode)
    x = np.random.default_rng(4).standard_normal((2, 3, 6, 16))
    ported, tree = _check(JProj(jc), Proj(tc), x, seed=5)
    assert "t5stack" in tree["params"]
    back = to_flax(ported)
    flat = jax.tree_util.tree_leaves_with_path(tree["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_proj_with_refiner_is_refused_where_jax_refuses():
    """``streaming_mix_spec`` refuses the refiner (it mixes across
    channels); the proj plan refuses a checkpoint with ``t5stack.`` keys,
    naming them, since JAX's converter reads none of them."""
    _, tc = _t5_cfgs("cnn")
    with pytest.raises(ValueError, match="t5 refiner"):
        streaming_mix_spec(Proj(tc), 2)
    keys = ["conv.weight", "t5stack.block.0.q.weight", "t5stack.rel_bias"]
    with pytest.raises(ValueError, match="t5stack.block.0.q.weight"):
        proj_plan(tc, keys)
