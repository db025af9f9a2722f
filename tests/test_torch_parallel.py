"""The port's parallel layer in one process, against the JAX package on the
8 virtual CPU devices where JAX has the function: the ring (one-process
form, 4 members) against JAX's ``ring_attention`` under a (2, 4) mesh, at
JAX's own bars (forward 2e-5, gradients 3e-5 / 1e-4); the tiny FLUX under
``ring_sequence`` and ``flux_pipeline_forward`` on 2 and 4 stages against
JAX's ``model.apply`` at 2e-5 (the bar JAX holds its pipeline to), the
pipeline's gradients against the plain forward's (the encoder input's at
JAX's 5e-5, the parameters' also within 1e-4 relative); the mesh's
rules and errors against JAX's ``make_mesh``; ``multihost``'s environment;
and JAX's four disaggregated cases in the one-process form. The process
form runs in ``test_torch_parallel_ranks.py``."""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_params import flux_tree, one_thread
from x2i_tpu.core import config as jcfg
from x2i_tpu.core import mesh as jmesh
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.models import flux as jflux
from x2i_tpu.ops.ring_attention import ring_attention as jring
from x2i_torch.core import config as tcfg
from x2i_torch.core import mesh as tmesh
from x2i_torch.core import multihost
from x2i_torch.models import flux as tflux
from x2i_torch.ops.ring_attention import ring_attention
from x2i_torch.parallel.axis import GroupAxis, LocalAxis
from x2i_torch.parallel.disaggregated import DisaggregatedDistill
from x2i_torch.parallel.pipeline import pipeline_apply
from x2i_torch.params import load_flax
from x2i_torch.train.harness import build_tiny_distill
from x2i_torch.train.runner import TrainLoop

S_IMG, S_TXT, GRID = 16, 8, 8


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape), names)


# ------------------------------------------------------------------- ring

@pytest.fixture(scope="module")
def ring_case():
    """JAX's ring forward (2, 256, 3, 64) and gradients (1, 128, 2, 32)
    under the (2, 4) mesh, on the inputs of tests/test_ops.py."""
    rng = np.random.default_rng(0)
    fwd = [rng.standard_normal((2, 256, 3, 64)).astype(np.float32)
           for _ in range(3)]
    bwd = [rng.standard_normal((1, 128, 2, 32)).astype(np.float32)
           for _ in range(4)]
    with jax.set_mesh(_mesh((2, 4), ("data", "tensor"))):
        out = jax.jit(lambda q, k, v: jring(q, k, v, "tensor", 4))(*fwd)

        def loss(q, k, v):
            return jnp.sum(jring(q, k, v, "tensor", 4) * bwd[3])

        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*bwd[:3])
    return fwd, bwd, np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_ring_matches_jax(ring_case, impl):
    """"auto" takes the plain pair functions on CPU tensors, "kernel" the
    kernel wrappers (K1 with the lse, K3/K4: their plain versions here)."""
    fwd, bwd, want, want_grads = ring_case
    axis = LocalAxis(4, "tensor")
    with torch.no_grad():
        got = ring_attention(*(t(x) for x in fwd), axis, implementation=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    q, k, v = (t(x).requires_grad_() for x in bwd[:3])
    loss = (ring_attention(q, k, v, axis, implementation=impl)
            * t(bwd[3])).sum()
    for g, w in zip(torch.autograd.grad(loss, (q, k, v)), want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=3e-5, rtol=1e-4)


def test_ring_rejects_indivisible_sequence():
    x = torch.zeros((1, 255, 2, 32))
    with pytest.raises(ValueError):
        ring_attention(x, x, x, LocalAxis(4))


def test_process_form_needs_a_group():
    """No fallback that hides the missing group."""
    with pytest.raises(RuntimeError):
        GroupAxis(None, "tensor")


# ------------------------------------------------------------------- FLUX

@pytest.fixture(scope="module")
def flux_case():
    """The tiny FLUX on a batch of 2, JAX's plain ``model.apply``."""
    jc = jcfg.tiny_flux_config()
    tree = flux_tree(0, jc, S_IMG, S_TXT)
    rng = np.random.default_rng(1)
    args = [rng.standard_normal((2, S_IMG, jc.in_channels)),
            rng.standard_normal((2, S_TXT, jc.joint_attention_dim)),
            rng.standard_normal((2, jc.pooled_projection_dim)),
            np.full((2,), 0.5), jsamp.prepare_latent_image_ids(GRID, GRID),
            np.zeros((S_TXT, 3))]
    args = [np.asarray(a, np.float32) for a in args]
    want = jax.jit(jflux.FluxTransformer2D(jc).apply)(
        tree, *(jnp.asarray(a) for a in args))
    return tree, args, np.asarray(want)


def _model(tree, **changes):
    return load_flax(tflux.FluxTransformer2D(
        tcfg.tiny_flux_config(**changes)), tree)


@pytest.mark.parametrize("ring", [1, 2])
def test_flux_ring_sequence_matches_jax(flux_case, ring):
    """A ring of 2 over the 24 joint tokens; a ring of 1 is the ordinary
    attention with the norm and the rope outside."""
    tree, args, want = flux_case
    model = _model(tree, ring_sequence=True).set_ring_axis(LocalAxis(ring))
    assert model.cfg.glue is None
    with torch.no_grad():
        got = model(*(t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_forward_matches_jax(flux_case, stages):
    """4 stages pad the tiny config's 2 double blocks to 4."""
    tree, args, want = flux_case
    model = _model(tree)
    with torch.no_grad():
        got = tflux.flux_pipeline_forward(model, *(t(a) for a in args),
                                          axis=LocalAxis(stages))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_pipeline_forward_gradients_match_plain(flux_case):
    """The gradient of the encoder input (JAX's case, at its 5e-5) and of
    every parameter (up to 40 in size here: f32 sums in another order,
    1e-4 relative) through the 4-stage schedule, against the plain
    forward's."""
    tree, args, _ = flux_case
    model = _model(tree)
    params = list(model.parameters())

    def grads(fn):
        enc = t(args[1]).requires_grad_()
        out = fn(t(args[0]), enc, *(t(a) for a in args[2:]))
        return torch.autograd.grad((out ** 2).sum(), [enc] + params)

    got = grads(functools.partial(tflux.flux_pipeline_forward, model,
                                  axis=LocalAxis(4)))
    want = grads(model)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=5e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-5,
                                   rtol=1e-4)


def test_pipeline_apply_rejects_indivisible_stacks():
    with pytest.raises(ValueError):
        pipeline_apply(lambda p, x: x, [0, 1, 2], [(torch.zeros(1),)],
                       LocalAxis(2))


# ------------------------------------------------------------------- mesh

@pytest.mark.parametrize("sizes", [(-1, 1, 1), (2, 4, 1), (2, -1, 2),
                                   (-1, 2, 2), (1, 1, -1)])
def test_mesh_shape_matches_jax(sizes):
    jm = jmesh.make_mesh(jcfg.MeshConfig(*sizes), devices=jax.devices()[:8])
    assert tmesh.mesh_shape(tcfg.MeshConfig(*sizes), 8) == list(
        jm.devices.shape)


@pytest.mark.parametrize("sizes", [(3, -1, 1), (2, 2, 1)])
def test_mesh_shape_errors_match_jax(sizes):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(jcfg.MeshConfig(*sizes), devices=jax.devices()[:8])
    with pytest.raises(ValueError) as terr:
        tmesh.mesh_shape(tcfg.MeshConfig(*sizes), 8)
    assert str(terr.value) == str(jerr.value)


@pytest.fixture
def one_process_mesh(monkeypatch):
    """make_mesh() with no group and no torchrun environment: the
    one-member mesh of this process (destroyed after the test)."""
    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_mesh(device_type="cpu")
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


def test_one_process_mesh(one_process_mesh):
    mesh = one_process_mesh
    assert mesh.mesh_dim_names == ("data", "fsdp", "tensor")
    assert tuple(mesh.mesh.shape) == (1, 1, 1)
    batch = {"x": torch.arange(6.0).reshape(3, 2), "s": torch.tensor(1.0)}
    got = tmesh.shard_batch(batch, mesh)
    assert torch.equal(got["x"], batch["x"]) and torch.equal(got["s"],
                                                             batch["s"])
    assert tmesh.data_index(mesh) == (0, 1)


def test_one_member_mesh_train_loop_is_the_plain_loop(one_process_mesh):
    """TrainLoop(mesh=) on a one-member mesh takes the steps of the loop
    without one, bit for bit."""
    def run(mesh):
        step, state, batch, _ = build_tiny_distill(batch_size=2,
                                                   device="cpu")
        TrainLoop(step, state, itertools.repeat(batch), seed=3,
                  mesh=mesh).run(2)
        return [p.detach().clone() for p in state.proj.parameters()]

    for a, b in zip(run(one_process_mesh), run(None)):
        assert torch.equal(a, b)


# -------------------------------------------------------------- multihost

def test_multihost_initialize_noop_single_process(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.is_main_process()


def test_multihost_env_parsing(monkeypatch):
    calls = {}

    def fake_init(backend, init_method, world_size, rank, timeout):
        calls.update(backend=backend, addr=init_method, n=world_size,
                     pid=rank)

    monkeypatch.setattr(multihost.dist, "init_process_group", fake_init)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "4321")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert multihost.initialize()
    assert calls == {"backend": "nccl", "addr": "tcp://10.0.0.1:4321",
                     "n": 4, "pid": 2}
    monkeypatch.delenv("MASTER_PORT")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.2:99")
    multihost.initialize(backend="gloo")
    assert calls == {"backend": "gloo", "addr": "tcp://10.0.0.2:99",
                     "n": 4, "pid": 2}
    assert multihost.coordinator_from_env()[0] == "10.0.0.2:99"
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    assert multihost.coordinator_from_env()[0] == "10.0.0.1:1234"


# ---------------------------------------------------------- disaggregated

CPU8 = ["cpu"] * 8


def _split(batch_size=4):
    (teacher_fn, student_fn), state, batch, parts = build_tiny_distill(
        batch_size=batch_size, split=True, device="cpu")
    frozen = [parts[k] for k in ("flux", "lm", "t5", "clip")]
    return teacher_fn, student_fn, frozen, state, batch


def test_disaggregated_pools_train():
    teacher_fn, student_fn, frozen, state, batch = _split()
    # 2 infer + 6 train, the reference's 8-GPU node
    dd = DisaggregatedDistill(teacher_fn, student_fn, frozen, frozen, state,
                              n_infer_devices=2, devices=CPU8)
    assert dd.infer.size == 2 and dd.train.size == 6
    losses = []
    for i in range(3):
        tout = dd.teacher_step(batch, 1)
        assert tout["latents"].device == dd.device
        m = dd.step(dd.train_batch(batch), tout, i)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("n_infer", [2, 4])
def test_disaggregated_matches_colocated(n_infer):
    """The same draws: the two pools' first-step loss is the colocated
    step's. With 4 + 4 the teacher runs one share of the batch per train
    member, its latents the shares of the whole batch's draw."""
    step_fn, state, batch, _ = build_tiny_distill(batch_size=4,
                                                  device="cpu")
    _, colocated = step_fn(state, batch, 7)
    teacher_fn, student_fn, frozen, state2, _ = _split()
    dd = DisaggregatedDistill(teacher_fn, student_fn, frozen, frozen,
                              state2, n_infer_devices=n_infer, devices=CPU8)
    assert dd.shares(batch) == (4 if n_infer == 4 else 1)
    m = dd.step(dd.train_batch(batch), dd.teacher_step(batch, 7), 7)
    np.testing.assert_allclose(float(m["loss"]), float(colocated["loss"]),
                               rtol=1e-4)


def test_disaggregated_train_stream():
    teacher_fn, student_fn, frozen, state, batch = _split()
    dd = DisaggregatedDistill(teacher_fn, student_fn, frozen, frozen, state,
                              n_infer_devices=2, devices=CPU8)
    stream = dd.train_stream(itertools.repeat(batch, 3), itertools.count())
    n = 0
    for train_batch, tout in stream:
        m = dd.step(train_batch, tout, n)
        assert np.isfinite(float(m["loss"]))
        n += 1
    assert n == 3


@pytest.mark.parametrize("n_infer", [0, 8])
def test_rejects_degenerate_pools(n_infer):
    teacher_fn, student_fn, frozen, state, _ = _split()
    with pytest.raises(ValueError):
        DisaggregatedDistill(teacher_fn, student_fn, frozen, frozen, state,
                             n_infer_devices=n_infer, devices=CPU8)


def test_config_fields():
    """MeshConfig field for field; ring_sequence turns the glue off."""
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.MeshConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.MeshConfig)}
    assert jf == tf
    cfg = tcfg.FluxConfig(fused_glue=True)
    assert cfg.glue == "ln" and dataclasses.replace(
        cfg, ring_sequence=True).glue is None
