"""The port's hand-written kernels against their plain PyTorch versions on
a CUDA card, at small shapes (chip_smoke.py holds them at the main path's
shapes). These tests import neither JAX nor the JAX package, so that they
run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a CUDA device each test skips itself: a CUDA kernel has no CPU
mode. Tolerances: flash attention within 1e-2 max and 1e-3 mean absolute
of the plain version in bf16 (f32 accumulation in another order, p rounded
to bf16 against a running max in the exact body); ln_mod's normalized row
within one bf16 step (2^-7 relative, 1e-4 absolute) of the plain
version's, and its modulate bit for bit.
"""

import pytest
import torch

from x2i_torch.diffusion.sampling import prepare_latent_image_ids
from x2i_torch.ops import attention as tattn
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops.rope import flux_rope_freqs_half

BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(g, dev, *shape):
    return torch.randn(shape, generator=g, device=dev, dtype=BF)


def _tables(s, d, dev):
    axes = (16, 24, 24) if d == 64 else (16, 56, 56)
    ids = torch.cat([torch.zeros((s - 64, 3), device=dev),
                     prepare_latent_image_ids(16, 16, dev)])
    return flux_rope_freqs_half(ids, axes)


def _close(got, want):
    diff = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("per_row", [True, False])
def test_flash_rope_kernel(dev, d, s, per_row):
    """K1a: in-kernel qk norm and rope; S=128 runs the exact body, S=256
    the pipelined one."""
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (_randn(g, dev, 2, s, 3, d).transpose(1, 2) for _ in range(3))
    shape = (s, d) if per_row else (d,)
    qw, kw = (1 + 0.1 * torch.randn(shape, generator=g, device=dev)
              for _ in range(2))
    kw_ = dict(rope=_tables(s, d, dev), qk_norm=(qw, kw, 1e-6))
    before = tfa.KERNEL.launches["flash_fwd_rope"]
    got = tfa.flash_attention(q, k, v, **kw_)
    assert tfa.KERNEL.launches["flash_fwd_rope"] == before + 1
    _close(got, tfa.flash_attention_plain(q, k, v, **kw_))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["mask+causal", "row0-masked", "causal",
                                  "plain"])
def test_flash_kernel_masks_and_gqa(dev, d, case):
    """K1b: GQA 6/2, kv mask, causal mask; a row with every key masked
    gives the mean of V; "plain" (no mask, S=256) runs the pipelined body
    without rope."""
    g = torch.Generator(device=dev).manual_seed(d)
    s = 256
    q = _randn(g, dev, 2, s, 6, d).transpose(1, 2)
    k, v = (_randn(g, dev, 2, s, 2, d).transpose(1, 2) for _ in range(2))
    mask = torch.arange(s, device=dev)[None] < torch.tensor(
        [[200], [37]], device=dev)
    if case == "row0-masked":
        mask[:, 0] = False
    kw = {}
    if "mask" in case:
        kw["kv_mask"] = mask
    if case != "plain":
        kw["causal"] = True
    got = tfa.flash_attention(q, k, v, **kw)
    _close(got, tfa.flash_attention_plain(q, k, v, **kw))
    if case == "row0-masked":
        mean_v = v.float().mean(dim=2).repeat_interleave(3, dim=1)
        assert (got[:, :, 0].float() - mean_v).abs().max() <= 1e-2


@pytest.mark.cuda
def test_dispatcher_pad_path_on_the_kernel(dev):
    """An odd joint length (200) is padded to 256 with masked keys and
    still runs the kernel, with rope and per-row qk norm."""
    g = torch.Generator(device=dev).manual_seed(1)
    s, d = 200, 64
    q, k, v = (_randn(g, dev, 1, s, 2, d) for _ in range(3))
    ids = torch.cat([torch.zeros((s - 64, 3), device=dev),
                     prepare_latent_image_ids(16, 16, dev)])
    rope = flux_rope_freqs_half(ids, (16, 24, 24))
    w = 1 + 0.1 * torch.randn((s, d), generator=g, device=dev)
    before = dict(tfa.KERNEL.launches)
    got = tattn.attention(q, k, v, rope=rope, qk_norm=(w, w, 1e-6))
    assert (tfa.KERNEL.launches["flash_fwd_rope"]
            == before["flash_fwd_rope"] + 1)
    want = tattn.attention(q, k, v, implementation="plain", rope=rope,
                           qk_norm=(w, w, 1e-6))
    _close(got, want)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 2, 128, 64), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_attention(q, q, q)                 # float32
    q = torch.zeros((1, 2, 96, 64), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention(q, q, q)                 # 96 % 64 != 0
    q = torch.zeros((1, 2, 128, 32), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention(q, q, q)                 # head dim 32


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 300])
def test_ln_mod_kernel(dev, rows):
    g = torch.Generator(device=dev).manual_seed(rows)
    # rows x * sigma + mu, sigma over four decades, as a residual stream
    sigma = 10.0 ** (4 * torch.rand((2, rows, 1), generator=g,
                                    device=dev) - 2)
    mu = 3 * sigma * torch.randn((2, rows, 1), generator=g, device=dev)
    x = (_randn(g, dev, 2, rows, 3072) * sigma + mu).to(BF)
    mod = _randn(g, dev, 2, 6 * 3072)
    shift, scale = mod[:, :3072], mod[:, 3072:6144]  # strided rows, as
    before = tfg.LAUNCHES["ln_mod"]                   # chunk(6) gives them
    got = tfg.ln_mod(x, shift, scale)
    assert tfg.LAUNCHES["ln_mod"] == before + 1
    # with shift = scale = 0 the kernel returns its normalized row y: one
    # bf16 step of the plain version's (f32 sums in another order), and
    # the modulate of that y is bit for bit the plain version's
    zero = torch.zeros_like(shift)
    y = tfg.ln_mod(x, zero, zero)
    y_plain = tfg.ln_mod_plain(x, zero, zero)
    tol = 2.0 ** -7 * y_plain.float().abs() + 1e-4
    assert bool(((y.float() - y_plain.float()).abs() <= tol).all())
    assert torch.equal(got, y * (1.0 + scale[:, None]) + shift[:, None])
    with pytest.raises(ValueError, match="bf16"):
        tfg.ln_mod(x.float(), shift.float(), scale.float())
