"""Ring attention at head dim 256 and in f32 on the kernels' route, on the
CPU:

* the port's ring (one-process form, 4 members) under
  ``implementation="kernel"`` (each pair through the kernel wrappers: K1
  with the lse forward, K3 and K4 backward, their plain versions on CPU
  tensors) against JAX's ``ring_attention`` under a (2, 4) mesh of the 8
  virtual CPU devices, on the same f32 arrays, at D = 256 and 128, forward
  and gradients, at JAX's own bars (forward 2e-5, gradients 3e-5 / 1e-4,
  as ``test_torch_parallel.py``);
* the ring's rule for "auto" (``ring_attention.use_kernels``) against the
  wrappers' own checks, for every head dim and dtype: a pair it sends to
  the kernels is one that K1 with the lse (K2 with the lse above
  ``MAX_KV_SEQ``), K3 and K4 take, and one they take is sent to them.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_params import one_thread  # noqa: F401
from x2i_tpu.ops.ring_attention import ring_attention as jring
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops import ring_attention as tra
from x2i_torch.parallel.axis import LocalAxis


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("d", [128, 256])
def test_ring_on_the_kernel_route_matches_jax(d, monkeypatch):
    """A ring of 4 over 512 tokens (128-token shards, the size the kernels
    take), 2 heads: the forward (2, 512, 2, d) and the gradients of
    sum(out * cotangent) at batch 1, each pair through the kernel
    wrappers (16 forwards, then 16 backwards)."""
    rng = np.random.default_rng(d)
    fwd = [rng.standard_normal((2, 512, 2, d)).astype(np.float32)
           for _ in range(3)]
    bwd = [rng.standard_normal((1, 512, 2, d)).astype(np.float32)
           for _ in range(4)]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "tensor"))
    with jax.set_mesh(mesh):
        want = jax.jit(lambda q, k, v: jring(q, k, v, "tensor", 4))(*fwd)

        def loss(q, k, v):
            return jnp.sum(jring(q, k, v, "tensor", 4) * bwd[3])

        want_grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*bwd[:3])
    calls = []
    for name in ("flash_forward_lse", "flash_backward"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    axis = LocalAxis(4, "tensor")
    with torch.no_grad():
        got = tra.ring_attention(*(t(x) for x in fwd), axis,
                                 implementation="kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert calls == ["flash_forward_lse"] * 16
    calls.clear()
    q, k, v = (t(x).requires_grad_() for x in bwd[:3])
    loss = (tra.ring_attention(q, k, v, axis, implementation="kernel")
            * t(bwd[3])).sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    assert calls == ["flash_forward_lse"] * 16 + ["flash_backward"] * 16
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=1e-4)


def _cuda_q(shape, dtype):
    """A stand-in for a CUDA tensor: what ``use_kernels`` reads of q."""
    return types.SimpleNamespace(shape=shape, dtype=dtype,
                                 device=torch.device("cuda"))


def _wrappers_take(q_shape, kv_seq, dtype) -> bool:
    """Whether the pair wrappers' checks pass: the dtype of an instance,
    the forward's shapes (K1 with the lse up to ``MAX_KV_SEQ`` keys, K2
    with the lse above it) and K3's and K4's."""
    b, h, _, d = q_shape
    kv = (b, h, kv_seq, d)
    try:
        tfa.instance_dtype(dtype, dtype, dtype)
        (tfa.check_shapes if kv_seq > tfa.MAX_KV_SEQ
         else tfa.check_kernel_shapes)(q_shape, kv, kv)
        tfa.check_kernel_shapes(q_shape, kv, kv, [q_shape])
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("d", [32, 64, 72, 128, 192, 256, 512])
def test_use_kernels_admits_what_the_wrappers_take(d, dtype):
    """For every head dim and dtype, over the ring's shard lengths (the
    12 x 256 DiT's 1152 at 1024^2 and 4224 and 8448 at 2048^2 on rings of 4
    and 2, and lengths off the kernels' tiles): "auto" sends a pair of
    CUDA tensors to the kernels exactly when their wrappers take it. At
    D = 256 in bf16 and f32 it does (the 12 x 256 DiT's ring)."""
    for s in (64, 128, 192, 1152, 4224, 8448, 8512):
        shape = (1, 12, s, d)
        admitted = tra.use_kernels(_cuda_q(shape, dtype), s, "auto")
        assert admitted == _wrappers_take(shape, s, dtype), (s, d, dtype)
        assert admitted == tra.kernels_take(shape, s, dtype)
        cpu = torch.empty(shape, dtype=dtype, device="meta")
        assert not tra.use_kernels(cpu, s, "auto")
        assert tra.use_kernels(cpu, s, "kernel")
        assert not tra.use_kernels(_cuda_q(shape, dtype), s, "plain")
    if d == 256 and dtype in (torch.bfloat16, torch.float32):
        for s in (1152, 4224, 8448):
            assert tra.use_kernels(_cuda_q((1, 12, s, d), dtype), s, "auto")
