"""The port's KD math (x2i_torch/ops/kd.py) and the trainer's kd_loss
against the JAX package's on the CPU, in float32 on the same numpy
inputs. Tolerance 1e-6 (absolute and relative; float32 sums over a few
thousand terms in another order); the int8 codes and scales exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x2i_tpu.ops import kd as jkd
from x2i_tpu.train import distill as jdistill
from x2i_torch.ops import kd as tkd
from x2i_torch.train import distill as tdistill

TOL = dict(atol=1e-6, rtol=1e-6)


def _pair(seed, shape=(2, 16, 64)):
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    s = (rng.standard_normal(shape) * 2 - 1).astype(np.float32)
    return t, s


def test_normalize_logit_matches_jax():
    x, _ = _pair(0)
    np.testing.assert_allclose(
        tkd.normalize_logit(torch.from_numpy(x)).numpy(),
        np.asarray(jkd.normalize_logit(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tau", [1.0, 3.0])
def test_kl_term_matches_jax(quantized, tau):
    t, s = _pair(1)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    if quantized:
        jt, tt = jkd.quantize_kd_tensor(jt), tkd.quantize_kd_tensor(tt)
    want = jkd.kl_term(jt, jnp.asarray(s), tau)
    got = tkd.kl_term(tt, torch.from_numpy(s), tau)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_non_finite_kl_term_counts_zero():
    t, s = _pair(2)
    t[0, 3, 5] = np.inf
    got = tkd.kl_term(torch.from_numpy(t), torch.from_numpy(s), 3.0)
    assert float(got) == 0.0
    assert float(jkd.kl_term(jnp.asarray(t), jnp.asarray(s), 3.0)) == 0.0


def test_quantize_and_dequantize_match_jax():
    t, _ = _pair(3)
    t[0, 0] = 0.0                          # an all-zero row: scale floor
    jq, js = jkd.quantize_kd_tensor(jnp.asarray(t))
    tq, ts = tkd.quantize_kd_tensor(torch.from_numpy(t))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.shape == (2, 16)
    np.testing.assert_array_equal(
        tkd.dequantize_kd((tq, ts)).numpy(),
        np.asarray(jkd.dequantize_kd((jq, js))))
    stacks = tkd.quantize_kd_stacks({"a": torch.from_numpy(t)})
    np.testing.assert_array_equal(stacks["a"][0].numpy(), np.asarray(jq))


@pytest.mark.parametrize("layout", ["reference", "scan"])
def test_kd_loss_matches_jax(layout):
    """Three stacks of 2 or 3 layers, (B, L, S, D) or (L, B, S, D)."""
    rng = np.random.default_rng(4)
    shapes = {"double_img": (2, 2, 8, 32), "double_txt": (2, 2, 4, 32),
              "single": (2, 3, 12, 32)}
    teacher, student = {}, {}
    for key, shape in shapes.items():
        if layout == "scan":
            shape = (shape[1], shape[0]) + shape[2:]
        teacher[key] = rng.standard_normal(shape).astype(np.float32)
        student[key] = rng.standard_normal(shape).astype(np.float32)
    want = jdistill.kd_loss({k: jnp.asarray(v) for k, v in teacher.items()},
                            {k: jnp.asarray(v) for k, v in student.items()},
                            3.0, layout=layout)
    got = tdistill.kd_loss(
        {k: torch.from_numpy(v) for k, v in teacher.items()},
        {k: torch.from_numpy(v) for k, v in student.items()}, 3.0,
        layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
