"""The DiT under ``shard_activations`` and ``shard_sequence`` in the
one-process form (``parallel/axis.py::LocalAxis``): the tiny FLUX of
JAX's test (``tests/test_flux.py::test_parallel_sharding_matches_unsharded``,
f32, 4 heads) against JAX's unsharded ``FluxTransformer2D.apply`` on the
same parameters, at that test's atol of 2e-4, on 2 and 4 members for each
flag set, with LightControl's controls too; in w8 against JAX's unsharded
w8 forward; in w8a8, w4a8 and w4 (a tree quantized at group 16, so that a
member's 32-160 inputs are whole groups; w4 with a non-identity AWQ
pre-scale) against JAX's unsharded forward in the mode, at the bars of
tests/test_torch_quant.py and test_torch_quant_int4.py, and w8a8 and w4a8
bit for bit the port's unsharded forward; the members' shards
(``parallel/tensor.py``) put back together bit for bit in every mode; the
axis's ``pmax`` and integer sums; K8's halves and the int32 products
split over members against the unsplit plain versions; and what the
slice does not run raising. The process form runs in
``test_torch_parallel_ranks.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke

from test_torch_params import flux_tree
from test_torch_quant_int4 import _quant_dense_at
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.models import flux as jflux
from x2i_tpu.ops import quant as jq
from x2i_torch.core import config as tcfg
from x2i_torch.models import flux as tflux
from x2i_torch.diffusion.sampling import denoise_flux
from x2i_torch.models import flux as tflux_mod
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops import int4_gemm as t4
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.ops import quant as tquant
from x2i_torch.ops.quant import QuantLinear, quantize_module_
from x2i_torch.parallel import tensor as tp
from x2i_torch.parallel.axis import GroupAxis, LocalAxis
from x2i_torch.params import load_flax

S_IMG, S_TXT, GRID = 16, 8, 8
GROUP = 16                 # the int4 group of the quantized trees
QUANT_MODES = ("w8a8", "w4a8", "w4")
FLAGS = {"tp": dict(shard_activations=True),
         "sp": dict(shard_sequence=True),
         "tp+sp": dict(shard_activations=True, shard_sequence=True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' small ops on one thread: with the test run's
    workers on every core, torch's thread pool made them several times
    slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _pre_scales(tree, rng):
    """``tree`` with every w4 ``pre_scale`` leaf drawn in [0.5, 2]: a
    non-identity AWQ equalization that the inputs are multiplied by."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                    if k == "pre_scale" else _pre_scales(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def quant_case(case):
    """The tiny FLUX's tree quantized in each of w8a8, w4a8 and w4 at
    group 16 (w4 with drawn pre-scales), and JAX's unsharded forward on it
    (the glue unfused, as under the flags), each jitted once: mode ->
    (tree, JAX's velocity)."""
    tree, _, args, _, _ = case
    jargs = [jnp.asarray(a) for a in args]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "QuantDense", _quant_dense_at(GROUP))
        for mode in QUANT_MODES:
            qtree = jq.quantize_tree(tree, mode, group=GROUP)
            if mode == "w4":
                qtree = _pre_scales(qtree, np.random.default_rng(2))
            jc = jcfg.tiny_flux_config(quantized=mode, fused_glue=False)
            out[mode] = (qtree, np.asarray(jax.jit(
                jflux.FluxTransformer2D(jc).apply)(qtree, *jargs)))
    return out


@pytest.fixture(scope="module")
def control_case(case):
    """LightControl's residuals for the tiny FLUX's 2 double blocks and
    JAX's unsharded forward with them (jitted once)."""
    tree, _, args, _, _ = case
    jc = jcfg.tiny_flux_config()
    controls = (np.random.default_rng(3).standard_normal(
        (jc.num_layers, 2, S_IMG, jc.inner_dim)) * 0.5).astype(np.float32)
    apply = functools.partial(jflux.FluxTransformer2D(jc).apply,
                              controls=jnp.asarray(controls))
    want = jax.jit(apply)(tree, *(jnp.asarray(a) for a in args))
    return controls, np.asarray(want)


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


@pytest.mark.parametrize("mode", [False, "w8", *QUANT_MODES])
@pytest.mark.parametrize("members", [2, 4])
def test_shards_put_back_together(case, quant_case, mode, members):
    """``shard_state`` and ``unshard_states`` bit for bit (the codes,
    scales, multipliers and pre-scales too, w4a8's codes packed again over
    each member's inputs); ``shard_module_`` leaves each member's module
    holding ``shard_state``'s tensors, at the member's widths."""
    tree = (quant_case[mode][0] if mode in QUANT_MODES
            else case[1] if mode else case[0])
    cfg = tcfg.tiny_flux_config(quantized=mode, shard_activations=True)
    whole = _model(tree, quantized=mode).state_dict()
    shards = [tp.shard_state(whole, cfg, m, members)
              for m in range(members)]
    back = tp.unshard_states(shards, cfg)
    assert back.keys() == whole.keys()
    assert all(torch.equal(back[k], whole[k]) for k in whole)
    leaf, per_byte = {False: ("weight", 1), "w8": ("qweight", 1),
                      "w8a8": ("qweight", 1)}.get(mode, ("pweight", 2))
    out = shards[1][f"single_blocks.0.out.{leaf}"]
    assert tuple(out.shape) == (128, (128 + 512) // members // per_byte)
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


@pytest.mark.parametrize("members", [2, 4])
@pytest.mark.parametrize("flags", ["tp", "tp+sp"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_sharded_forward_matches_jax(quant_case, case, mode, flags,
                                               members):
    """w8a8, w4a8 and w4 split over 2 or 4 members against JAX's
    unsharded forward in the mode: w4 within 1e-3 relative; w8a8 and w4a8
    at the two-evaluations bar (correlation above 0.999, relative L2 below
    5e-2): an activation code flips where f32 sums in another order cross
    a rounding boundary, and on this tree the port's unsharded w8a8
    forward is 1.9e-3 from JAX's (a flip in the last single block; 2e-7
    to 5e-3 over tree seeds 0-3), which a split cannot change. So w8a8 and
    w4a8 are held bit for bit to the port's unsharded forward: the
    members' int32 sums at the whole row's scale are the whole layer's."""
    tree, want = quant_case[mode]
    args = [t(a) for a in case[2]]
    model = _model(tree, quantized=mode, **FLAGS[flags]).set_tensor_axis(
        LocalAxis(members, "tensor"))
    with torch.no_grad():
        got = model(*args)
    g = got.numpy()
    rel = np.linalg.norm(g - want) / np.linalg.norm(want)
    if mode != "w4":
        corr = np.corrcoef(g.ravel(), want.ravel())[0, 1]
        assert corr > 0.999 and rel < 5e-2, (corr, rel)
    else:
        assert rel <= 1e-3, rel
    if mode != "w4":
        with torch.no_grad():
            assert torch.equal(got, _model(tree, quantized=mode)(*args))


@pytest.mark.parametrize("members", [2, 4])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_sharded_controls_match_jax(case, control_case, flags, members):
    """LightControl's residuals under the flags (each member's token block
    of them under ``shard_sequence``) against JAX's unsharded forward with
    the same controls, at atol 2e-4."""
    tree, _, args, _, _ = case
    controls, want = control_case
    model = _model(tree, **FLAGS[flags]).set_tensor_axis(
        LocalAxis(members, "tensor"))
    with torch.no_grad():
        got = model(*(t(a) for a in args), controls=t(controls))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("form", ["local", "group"])
def test_pmax_and_integer_sums(tmp_path, form):
    """``pmax`` the members' elementwise max, and ``psum`` /
    ``psum_scatter`` of int32 parts exact in their dtype, above 2^24
    where an f32 sum rounds; on one member of a group of one process, the
    part itself. Both refuse grad in the process form."""
    g = torch.Generator().manual_seed(0)
    parts = [torch.randint(-2 ** 30, 2 ** 30, (1, 8, 6), generator=g,
                           dtype=torch.int32) // 4 for _ in range(4)]
    amax = [torch.rand(1, 8, 1, generator=g) for _ in range(4)]
    if form == "local":
        axis = LocalAxis(4, "tensor")
        whole = parts[0] + parts[1] + parts[2] + parts[3]
        assert axis.psum(parts).dtype == torch.int32
        assert torch.equal(axis.psum(parts), whole)
        assert all(torch.equal(a, b) for a, b in zip(
            axis.psum_scatter(parts, 1), whole.split(2, 1)))
        assert torch.equal(axis.pmax(amax), torch.stack(amax).amax(0))
        return
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        axis = GroupAxis(dist.group.WORLD, "tensor")
        assert torch.equal(axis.psum(parts[:1]), parts[0])
        assert torch.equal(axis.psum_scatter(parts[:1], 1)[0], parts[0])
        assert torch.equal(axis.pmax(amax[:1]), amax[0])
        x = torch.ones(2, 4, requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            axis.pmax([x])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("members", [2, 4])
def test_split_products_equal_the_whole(members):
    """K8's halves' plain versions on a row split into members' blocks:
    the members' absmax maximum, and each block's codes and scale at it,
    are the whole row's ``quant_rows_plain`` bits (tie rows included);
    the int32 products of the blocks (int8 and w4a8, the w4a8 layer's
    members packed again by ``QuantLinear.sliced``) sum to the whole
    product's, exactly."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((3, 5, 384)) * 3).astype(
        np.float32)).to(torch.bfloat16)
    x[0, 0] = (torch.arange(384) % 254 - 127 + 0.5).to(torch.bfloat16) / 8
    x[0, 0, 7] = 15.875                     # every quotient k + 0.5
    q, a = tfg.quant_rows_plain(x)
    blocks = x.split(384 // members, -1)
    amax = torch.stack([tfg.row_absmax_plain(b) for b in blocks]).amax(0)
    got = [tfg.quant_rows_at_plain(b, amax) for b in blocks]
    assert torch.equal(torch.cat([c for c, _ in got], -1), q)
    assert all(torch.equal(s, a) for _, s in got)
    w = torch.from_numpy(rng.standard_normal((64, 384)).astype(np.float32))
    for mode in ("w8a8", "w4a8"):
        layer = QuantLinear(384, 64, mode=mode, dtype=torch.float32,
                            group=GROUP)
        layer.set_weight_(w)
        whole = layer.acc(q)
        step = 384 // members
        parts = [layer.sliced("in", [(m * step, (m + 1) * step)]).acc(c)
                 for m, (c, _) in enumerate(got)]
        assert torch.equal(sum(parts), whole), mode
    assert torch.equal(whole, t4.w4a8_matmul_acc_plain(
        q, layer.pweight, layer.mscale))
    assert torch.equal(QuantLinear(384, 64, dtype=torch.float32).acc(q),
                       tgemm.int8_matmul_acc_plain(q, torch.zeros(
                           64, 384, dtype=torch.int8)))


@pytest.mark.parametrize("mode", ["w4a8", "w4"])
def test_check_split_names_a_layer_off_its_groups(mode):
    """The tiny DiT quantized at the default group of 128: its members'
    32-160 inputs of a row-split layer are not whole groups (w4a8 halves
    the group of a 128-wide input to 64, for an even count), and
    ``set_tensor_axis`` raises naming the layer and the group."""
    model = tflux.FluxTransformer2D(tcfg.tiny_flux_config(
        shard_activations=True))
    quantize_module_(model, mode)
    group = 128 if mode == "w4" else 64
    with pytest.raises(ValueError, match=r"double_blocks\.0\.img_attn_out"
                       rf".*groups of {group}"):
        model.set_tensor_axis(LocalAxis(4, "tensor"))


# the wrappers whose calls on the CPU are the card's launches, by module
# and name -> the launch counter
COUNTED = ((tquant, "quant_rows", "quant_rows"),
           (tflux_mod, "quant_rows", "quant_rows"),
           (tp, "row_absmax", "row_absmax"),
           (tp, "quant_rows_at", "quant_rows_at"),
           (tquant, "int8_linear", "int8_gemm"),
           (tquant, "w4a8_linear", "w4a8_gemm"),
           (tquant, "int8_matmul_acc", "int8_gemm_acc"),
           (tquant, "w4a8_matmul_acc", "w4a8_gemm_acc"),
           (tquant, "dequant_linear", "dequant_gemm"))


@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_tensor_launches_count_the_wrappers_calls(monkeypatch, mode,
                                                  members):
    """``chip_smoke.tensor_launches``'s counts of the quantized kernels
    for "tp" (2 denoise steps of a 2 + 4-block DiT, the adaLN pass first,
    as the pipeline runs them) against the wrappers' calls, each counted
    under its launch counter's name."""
    calls = {}

    def counted(fn, key):
        def wrapped(*args, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for module, name, key in COUNTED:
        monkeypatch.setattr(module, name,
                            counted(getattr(module, name), key))
    model = tflux.FluxTransformer2D(tcfg.tiny_flux_config(**FLAGS["tp"]))
    quantize_module_(model, mode, group=GROUP)
    model.set_tensor_axis(LocalAxis(members, "tensor"))
    g = torch.Generator().manual_seed(0)
    cfg = model.cfg
    with torch.no_grad():
        denoise_flux(model, torch.randn(1, S_IMG, cfg.in_channels,
                                        generator=g),
                     torch.randn(1, S_TXT, cfg.joint_attention_dim,
                                 generator=g),
                     torch.randn(1, cfg.pooled_projection_dim, generator=g),
                     torch.tensor([1.0, 0.5, 0.0]),
                     t(jsamp.prepare_latent_image_ids(GRID, GRID)),
                     torch.zeros(S_TXT, 3))
    want = chip_smoke.tensor_launches("tp", members, quantized=mode,
                                      steps=2, n2=2, n1=4)
    assert calls == {k: v for k, v in want.items() if v and k in {
        key for _, _, key in COUNTED}}


# ----------------------------------------------------------------- errors

@pytest.mark.parametrize("mode", ["w8a8", "w4a8", "w4"])
def test_other_quantized_modes_raise(case, mode):
    """What the other quantized modes still refuse under
    ``shard_activations``: a block of a layer's inputs off its groups (w4,
    w4a8: naming the group; an odd count of groups in w4a8), and the
    backward of a DiT whose row-split layers sum int32 parts (w8a8,
    w4a8), naming the mode. None falls back to another route."""
    layer = QuantLinear(64, 32, mode=mode, group=GROUP)
    if mode == "w8a8":
        assert layer.sliced("in", [(0, 8)]).in_features == 8
    else:
        with pytest.raises(ValueError, match=f"groups of {GROUP}"):
            layer.sliced("in", [(0, 8)])
    if mode == "w4a8":
        with pytest.raises(ValueError, match="even count"):
            layer.sliced("in", [(0, 48)])
    assert layer.sliced("out", [(0, 16)]).out_features == 16
    model = tflux.FluxTransformer2D(tcfg.tiny_flux_config(
        shard_activations=True))
    quantize_module_(model, mode, group=GROUP)
    model.requires_grad_(False).set_tensor_axis(LocalAxis(2, "tensor"))
    g = torch.Generator().manual_seed(0)
    cfg = model.cfg
    args = [torch.randn(1, S_IMG, cfg.in_channels, generator=g),
            torch.randn(1, S_TXT, cfg.joint_attention_dim, generator=g)
            .requires_grad_(),
            torch.randn(1, cfg.pooled_projection_dim, generator=g),
            torch.full((1,), 0.5),
            t(jsamp.prepare_latent_image_ids(GRID, GRID)),
            torch.zeros(S_TXT, 3)]
    if mode == "w4":                   # floating parts: straight-through
        assert model(*args).requires_grad
    else:
        with pytest.raises(NotImplementedError, match=mode):
            model(*args)


def test_indivisible_heads_and_tokens_raise(case):
    tree, _, args, _, _ = case
    with pytest.raises(ValueError, match="4 attention heads"):
        _model(tree, shard_activations=True).set_tensor_axis(LocalAxis(3))
    sp = _model(tree, shard_sequence=True).set_tensor_axis(LocalAxis(3))
    with torch.no_grad(), pytest.raises(ValueError, match="16 image tokens"):
        sp(*(t(a) for a in args))


def test_unported_combinations_raise(case):
    """No tensor axis, ``ring_sequence`` beside the flags, KD outputs or
    targets, the pipelined forward, and the DiT's own weights trained
    under ``shard_activations``: each raises, none falls back (controls
    serve: ``test_sharded_controls_match_jax``)."""
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
        with pytest.raises(NotImplementedError, match="KD stacks"):
            model(*targs, return_attn_outputs=True)
        with pytest.raises(NotImplementedError, match="KD targets"):
            model(*targs, kd_targets={})
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
