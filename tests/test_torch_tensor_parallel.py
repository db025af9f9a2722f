"""The DiT under ``shard_activations`` and ``shard_sequence`` in the
one-process form (``parallel/axis.py::LocalAxis``): the tiny FLUX of
JAX's test (``tests/test_flux.py::test_parallel_sharding_matches_unsharded``,
f32, 4 heads) against JAX's unsharded ``FluxTransformer2D.apply`` on the
same parameters, at that test's atol of 2e-4, on 2 and 4 members for each
flag set; in w8 against JAX's unsharded w8 forward; the members' shards
(``parallel/tensor.py``) put back together bit for bit; and what the
slice does not run raising. The process form runs in
``test_torch_parallel_ranks.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_params import flux_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.models import flux as jflux
from x2i_tpu.ops import quant as jq
from x2i_torch.core import config as tcfg
from x2i_torch.models import flux as tflux
from x2i_torch.ops.quant import QuantLinear, quantize_module_
from x2i_torch.parallel import tensor as tp
from x2i_torch.parallel.axis import GroupAxis, LocalAxis
from x2i_torch.params import load_flax

S_IMG, S_TXT, GRID = 16, 8, 8
FLAGS = {"tp": dict(shard_activations=True),
         "sp": dict(shard_sequence=True),
         "tp+sp": dict(shard_activations=True, shard_sequence=True)}


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _args(rng, cfg, b=2):
    args = [rng.standard_normal((b, S_IMG, cfg.in_channels)),
            rng.standard_normal((b, S_TXT, cfg.joint_attention_dim)),
            rng.standard_normal((b, cfg.pooled_projection_dim)),
            np.full((b,), 0.5), jsamp.prepare_latent_image_ids(GRID, GRID),
            np.zeros((S_TXT, 3))]
    return [np.asarray(a, np.float32) for a in args]


@pytest.fixture(scope="module")
def case():
    """JAX's tiny FLUX on a batch of 2, unsharded, in f32 and in w8 (its
    tree through ``quantize_tree``); jitted once each."""
    jc = jcfg.tiny_flux_config()
    tree = flux_tree(0, jc, S_IMG, S_TXT)
    args = _args(np.random.default_rng(1), jc)
    jargs = [jnp.asarray(a) for a in args]
    want = jax.jit(jflux.FluxTransformer2D(jc).apply)(tree, *jargs)
    w8_tree = jq.quantize_tree(tree, "w8")
    want_w8 = jax.jit(jflux.FluxTransformer2D(
        jcfg.tiny_flux_config(quantized="w8")).apply)(w8_tree, *jargs)
    return tree, w8_tree, args, np.asarray(want), np.asarray(want_w8)


def _model(tree, **changes):
    return load_flax(tflux.FluxTransformer2D(
        tcfg.tiny_flux_config(**changes)), tree)


@pytest.mark.parametrize("members", [2, 4])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_sharded_forward_matches_jax(case, flags, members):
    """4 heads and an FFN of 512 split over 2 or 4 members; 8 text and 16
    image tokens (24 joint) too."""
    tree, _, args, want, _ = case
    model = _model(tree, **FLAGS[flags]).set_tensor_axis(
        LocalAxis(members, "tensor"))
    assert model.cfg.glue is None
    with torch.no_grad():
        got = model(*(t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_axis_of_one_is_the_unsharded_route(case, flags):
    """The flags over one member: the blocks' own forward, bit for bit
    (the glue unfused, as under the flags)."""
    tree, _, args, _, _ = case
    sharded = _model(tree, **FLAGS[flags]).set_tensor_axis(LocalAxis(1))
    plain = _model(tree)
    with torch.no_grad():
        assert torch.equal(sharded(*(t(a) for a in args)),
                           plain(*(t(a) for a in args)))


@pytest.mark.parametrize("flags", ["tp", "tp+sp"])
def test_w8_sharded_forward_matches_jax(case, flags):
    """w8 layers split by their codes' rows or columns (the scale follows
    the output channels): against JAX's unsharded w8 forward (1e-3
    relative, the bar of tests/test_torch_quant.py in f32)."""
    _, w8_tree, args, _, want = case
    model = _model(w8_tree, quantized="w8", **FLAGS[flags])
    model.set_tensor_axis(LocalAxis(4, "tensor"))
    with torch.no_grad():
        got = model(*(t(a) for a in args)).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3


@pytest.mark.parametrize("mode", [False, "w8"])
@pytest.mark.parametrize("members", [2, 4])
def test_shards_put_back_together(case, mode, members):
    """``shard_state`` and ``unshard_states`` bit for bit (w8's qweight
    and scale too); ``shard_module_`` leaves each member's module holding
    ``shard_state``'s tensors, at the member's widths."""
    tree = case[1] if mode else case[0]
    cfg = tcfg.tiny_flux_config(quantized=mode, shard_activations=True)
    whole = _model(tree, quantized=mode).state_dict()
    shards = [tp.shard_state(whole, cfg, m, members)
              for m in range(members)]
    back = tp.unshard_states(shards, cfg)
    assert back.keys() == whole.keys()
    assert all(torch.equal(back[k], whole[k]) for k in whole)
    leaf = "qweight" if mode else "weight"
    out = shards[1][f"single_blocks.0.out.{leaf}"]
    assert tuple(out.shape) == (128, (128 + 512) // members)
    for m in (0, members - 1):
        module = tp.shard_module_(_model(tree, quantized=mode), m, members)
        got = module.state_dict()
        assert got.keys() == shards[m].keys()
        assert all(torch.equal(got[k], shards[m][k]) for k in got)


def test_gradient_through_the_one_process_form(case):
    """The one-process form differentiates: the gradient of the encoder
    input through the frozen DiT under both flags, against the unsharded
    forward's."""
    tree, _, args, _, _ = case

    def grad(model):
        model.requires_grad_(False)
        enc = t(args[1]).requires_grad_()
        out = model(t(args[0]), enc, *(t(a) for a in args[2:]))
        return torch.autograd.grad(out.square().sum(), enc)[0]

    got = grad(_model(tree, **FLAGS["tp+sp"]).set_tensor_axis(
        LocalAxis(2, "tensor")))
    np.testing.assert_allclose(got.numpy(), grad(_model(tree)).numpy(),
                               atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------- errors

@pytest.mark.parametrize("mode", ["w8a8", "w4a8", "w4"])
def test_other_quantized_modes_raise(case, mode):
    model = tflux.FluxTransformer2D(tcfg.tiny_flux_config(
        shard_activations=True))
    quantize_module_(model, mode)
    with pytest.raises(NotImplementedError, match=mode):
        model.set_tensor_axis(LocalAxis(2, "tensor"))
    layer = QuantLinear(64, 32, mode=mode)
    with pytest.raises(NotImplementedError, match=mode):
        layer.sliced("out", [(0, 16)])


def test_indivisible_heads_and_tokens_raise(case):
    tree, _, args, _, _ = case
    with pytest.raises(ValueError, match="4 attention heads"):
        _model(tree, shard_activations=True).set_tensor_axis(LocalAxis(3))
    sp = _model(tree, shard_sequence=True).set_tensor_axis(LocalAxis(3))
    with torch.no_grad(), pytest.raises(ValueError, match="16 image tokens"):
        sp(*(t(a) for a in args))


def test_unported_combinations_raise(case):
    """No tensor axis, ``ring_sequence`` beside the flags, controls or KD
    outputs, the pipelined forward, and the DiT's own weights trained
    under ``shard_activations``: each raises, none falls back."""
    tree, _, args, _, _ = case
    targs = [t(a) for a in args]
    with torch.no_grad():
        with pytest.raises(ValueError, match="tensor axis"):
            _model(tree, shard_sequence=True)(*targs)
        ring = _model(tree, shard_activations=True, ring_sequence=True)
        with pytest.raises(NotImplementedError, match="ring_sequence"):
            ring.set_tensor_axis(LocalAxis(2))(*targs)
        model = _model(tree, shard_activations=True).set_tensor_axis(
            LocalAxis(2))
        with pytest.raises(NotImplementedError, match="serves only"):
            model(*targs, return_attn_outputs=True)
        with pytest.raises(NotImplementedError, match="pipelined"):
            tflux.flux_pipeline_forward(model, *targs, axis=LocalAxis(2))
    with pytest.raises(NotImplementedError, match="requires_grad_"):
        model(*targs)


def test_members_follow_a_swapped_layer(case):
    """A layer swapped after ``set_tensor_axis`` (quantized in place) is
    noticed, not served from the old members."""
    tree, _, args, _, _ = case
    model = _model(tree, shard_activations=True).set_tensor_axis(
        LocalAxis(2))
    quantize_module_(model, "w8")
    with torch.no_grad(), pytest.raises(RuntimeError, match="again"):
        model(*(t(a) for a in args))


def test_process_form_collectives_refuse_grad(tmp_path):
    """``GroupAxis.psum`` and ``psum_scatter`` (a group of one process)
    raise on a tensor that requires grad: their gradient would be
    silently wrong."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        axis = GroupAxis(dist.group.WORLD, "tensor")
        x = torch.ones(2, 4, requires_grad=True)
        for fn in (lambda: axis.psum([x]),
                   lambda: axis.psum_scatter([x], 1)):
            with pytest.raises(RuntimeError, match="no backward"):
                fn()
        with torch.no_grad():
            assert torch.equal(axis.psum([x]), x)
    finally:
        dist.destroy_process_group()
