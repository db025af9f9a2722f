"""The port's hand-written kernels against their plain PyTorch versions on
a CUDA card, at small shapes (chip_smoke.py holds them at the main path's
shapes). These tests import neither JAX nor the JAX package, so that they
run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a CUDA device each test skips itself: a CUDA kernel has no CPU
mode. The K1 cases sit on the edges of its tiling (128-row q tiles on two
warpgroups, or 64-row ones where the grid is small; 128-row kv tiles in K
and V rings of 3; at D = 64 the 64-row instance at three blocks an SM, its
kv tiles 64 rows in rings of 4, on every grid instance): one
and two kv tiles, 4608 and 8192 tokens, Sq != Skv, GQA groups 1, 3 and 7,
strided and contiguous inputs, MiniCPM-o's resampler (64 queries padded
to 128 rows on a batch of slices with masked keys); the K3 and K4 cases on the edges of theirs
(one 128-row tile, a ring of 64-row tiles that wraps, K4's split over the
grid with and without rope); the K2 cases on the edges of its (128 q
rows by 128 kv rows, a ring of 3 stages, a last tile of 64 rows on either
side); the int8 GEMM's on the edges of its (128 x 256 tiles, a ring of
128-byte K steps, few rows, koff); K5's and K7's (``csrc/row_glue.cu``)
on the edges of their persistent row spans (a span that crosses one or
two batch boundaries, a ring that wraps, 1 row, 4608 rows, the generic
instances at other widths), K6's on the same edges, and K8 bit for bit
at every width of the w8a8 path, on rows whose quotients are all ties
too.
Tolerances: flash attention within 1e-2
max and 1e-3 mean absolute of the plain version in bf16 (f32 accumulation in another order, p rounded
to bf16 against a running max in the exact body), its lse within 1e-3 in
log2 units; the backward kernels K3 and K4 within 2e-2 max and 2e-3 mean
absolute error relative to the largest gradient (bf16 outputs, ds and p
rounded to bf16 at the same points, summed in another order); ln_mod's
normalized row
within one bf16 step (2^-7 relative, 1e-4 absolute) of the plain
version's, and its modulate bit for bit. quant_rows (K8) bit for bit
(its max, IEEE divisions and rounding leave no room); ln_mod_quant (K6)
codes within one step, at most 1% flipped, scales within one bf16 step
(a normalized value can flip by one bf16 step, as in ln_mod), and bit
for bit K8 after K5 (one LayerNorm + modulate in both); gelu_quant (K7)
the JAX package's bar: codes within one step, at most 10% flipped,
scales within rtol 2e-2 (its exp form of the tanh against PyTorch's
tanhf). The int8 GEMM: its int32 sum exact, its bf16 output within one
bf16 step. The w4a8 GEMM (``ops/int4_gemm.py``) the same, on the edges
of its packed steps (128 packed bytes give a low and a high K step: a
chunk in one half, a chunk across it, in/2 of 32 and of 128 bytes, rings
that wrap, groups of 32 and 48); the w4 dequantize kernel bit for bit
(one rounding of a product that is exact in f32), and so the
straight-through backward's int8 and w4a8 dequantize kernels; the
dequantizing GEMM's converted weight bit for bit the dequantize kernels',
its output within two bf16 roundings of the plain version's; a
QuantLinear's straight-through dx in each mode within one bf16 step of
the largest value of the CPU's (f32 sums in cuBLAS's order). K1's f32
instance (f32 q, k, v rounded to bf16 on the card, o in f32) within the
bf16 bars of the f32 plain version, on the routes "auto" gives it; the f32
instances of K1 with the lse, K2, K3 and K4 no farther in relative L2 from
their f32 plain versions than the bf16 instances on the same inputs
rounded to bf16, their outputs rounded to bf16 bit for bit the bf16
instances'. Head dim 256: K1's bodies (64-row kv tiles in K and V rings
of 2 stages, both grid instances) within K1's bars, K2 within them plus one
bf16 step of |o| (causal rows of a few keys reach |o| of 2-4), K1 and K2
with the lse within the lse bar, K3 (32-row kv tiles in a ring of 2) and
K4 (64-row kv blocks, each warpgroup on half of the columns) on every case
of the D = 64 and 128 ones, bf16 and f32; K1's f32 rope-and-norm
instance rounded to bf16 bit
for bit the bf16 K1a's on the rounded inputs; K5 on f32 rows within 1e-5
of the plain version (f32 row statistics summed in another order). The
data
loader's side-stream copy (``StreamCopy``): each batch on the card bit
for bit its numpy batch, read at once by a busy consumer stream.
"""

import math

import pytest
import torch

from x2i_torch.core.config import tiny_flux_config
from x2i_torch.diffusion.sampling import prepare_latent_image_ids
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.ops import attention as tattn
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops import int4_gemm as t4
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.ops.rope import flux_rope_freqs_half
from x2i_torch.params import random_init_

BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(g, dev, *shape):
    return torch.randn(shape, generator=g, device=dev, dtype=BF)


def _tables(s, d, dev):
    axes = {64: (16, 24, 24), 128: (16, 56, 56), 256: (32, 112, 112)}[d]
    ids = torch.cat([torch.zeros((s - 64, 3), device=dev),
                     prepare_latent_image_ids(16, 16, dev)])
    return flux_rope_freqs_half(ids, axes)


def _close(got, want):
    diff = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3


def _layout(t, layout):
    """(B, S, H, D) storage -> the (B, H, S, D) tensor a kernel gets: the
    strided view the dispatcher passes, or a contiguous copy."""
    t = t.transpose(1, 2)
    return t.contiguous() if layout == "contiguous" else t


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 256, 4608, 8192])
@pytest.mark.parametrize("case", ["per-row", "shared", "contiguous",
                                  "clamp"])
def test_flash_rope_kernel(dev, d, s, case):
    """K1a: in-kernel qk norm and rope, batch 2; S=128 is one kv tile and
    runs the exact body, S=256 is the least the pipelined body takes (two
    tiles), 4608 and 8192 (the longest the kernel takes) fill the card, so
    they run the two-warpgroup instance, the short ones the 64-row one.
    "contiguous" passes (B, H, S, D) tensors instead of the strided views;
    "clamp" has k = q and qk scales of 3, so every row's own score passes
    100 in log2 units and exp2 would overflow without the clamp."""
    g = torch.Generator(device=dev).manual_seed(s + d)
    layout = "contiguous" if case == "contiguous" else "strided"
    q, k, v = (_layout(_randn(g, dev, 2, s, 3, d), layout) for _ in range(3))
    shape = (s, d) if case == "per-row" else (d,)
    qw, kw = (1 + 0.1 * torch.randn(shape, generator=g, device=dev)
              for _ in range(2))
    rope = _tables(s, d, dev)
    if case == "clamp":
        k, qw = q, torch.full((d,), 3.0, device=dev)
        kw = qw
        qn = tfa._rotate(tfa._norm_rows(q.float(), qw, 1e-6), *rope)
        assert (qn.square().sum(-1) * tfa.LOG2_E / d ** 0.5 > 100).all()
    kw_ = dict(rope=rope, qk_norm=(qw, kw, 1e-6))
    before = tfa.KERNEL.launches["flash_fwd_rope"]
    got = tfa.flash_attention(q, k, v, **kw_)
    assert tfa.KERNEL.launches["flash_fwd_rope"] == before + 1
    _close(got, tfa.flash_attention_plain(q, k, v, **kw_))


# case -> (Sq, Skv, q heads, kv heads, kv mask, causal, layout)
MASK_CASES = {
    "mask+causal": (256, 256, 6, 2, True, True, "strided"),
    "row0-masked": (256, 256, 6, 2, True, True, "strided"),
    "causal": (256, 256, 6, 2, False, True, "strided"),
    "plain": (256, 256, 6, 2, False, False, "strided"),
    "one-tile": (128, 128, 3, 3, False, False, "strided"),
    "one-tile-mask+causal": (128, 128, 6, 2, True, True, "strided"),
    "gqa1-mask+causal": (512, 512, 2, 2, True, True, "strided"),
    "gqa7-mask+causal": (512, 512, 14, 2, True, True, "strided"),
    "gqa7-contiguous": (512, 512, 14, 2, True, True, "contiguous"),
    "sq128-skv1152-mask": (128, 1152, 6, 2, True, False, "strided"),
    "sq1152-skv128": (1152, 128, 3, 3, False, False, "strided"),
    "plain-contiguous": (256, 256, 6, 2, False, False, "contiguous"),
    # enough 128-row blocks (2 x 36 x 6) for the two-warpgroup instance
    "wide-mask+causal": (768, 768, 36, 12, True, True, "strided"),
    "wide-row0-masked": (768, 768, 36, 12, True, True, "strided"),
    "wide-causal": (768, 768, 36, 36, False, True, "contiguous"),
    "wide-plain": (768, 768, 36, 12, False, False, "strided"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(MASK_CASES))
def test_flash_kernel_masks_and_gqa(dev, d, case):
    """K1b and K1c, batch 2: GQA groups 1, 3 and 7, kv mask, causal mask;
    a row with every key masked gives the mean of V; one kv tile (128),
    Sq != Skv (128 x 1152 exact under a mask, 1152 x 128 exact for its
    single tile); the "plain" cases (no mask, Skv >= 256) run the
    pipelined body without rope; the "wide" cases have enough blocks for
    the two-warpgroup instance, the others run the 64-row one."""
    g = torch.Generator(device=dev).manual_seed(d)
    sq, skv, hq, hk, masked, causal, layout = MASK_CASES[case]
    q = _layout(_randn(g, dev, 2, sq, hq, d), layout)
    k, v = (_layout(_randn(g, dev, 2, skv, hk, d), layout) for _ in range(2))
    mask = torch.arange(skv, device=dev)[None] < torch.tensor(
        [[skv - 56], [37]], device=dev)
    if "row0-masked" in case:
        mask[:, 0] = False
    kw = {}
    if masked:
        kw["kv_mask"] = mask
    if causal:
        kw["causal"] = True
    name = "flash_fwd" if tfa.is_exact(kw.get("kv_mask"), causal, skv) \
        else "flash_fwd_pipe"
    before = tfa.KERNEL.launches[name]
    got = tfa.flash_attention(q, k, v, **kw)
    assert tfa.KERNEL.launches[name] == before + 1
    _close(got, tfa.flash_attention_plain(q, k, v, **kw))
    if "row0-masked" in case:
        mean_v = v.float().mean(dim=2).repeat_interleave(hq // hk, dim=1)
        assert (got[:, :, 0].float() - mean_v).abs().max() <= 1e-2


def _grad_close(got, want):
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max()
    assert bool(torch.isfinite(got).all()) and got.dtype == want.dtype
    assert diff.max() <= 2e-2 * top and diff.mean() <= 2e-3 * top


# case -> (S, q heads, kv heads, layout, batch); "mask" adds a kv mask with
# a fully masked row under the causal mask, "rope" the rotation inside.
# K3 and K4 stream 64-row tiles through a ring of four stages, which wraps
# above 256 rows; K4 splits its stages over the grid where its 128-row kv
# blocks are fewer than the card's SMs (every case but the "wide" ones).
# At D = 256 K3's ring is 3 stages of 32 kv rows and K4's blocks 64 rows,
# its warpgroups by role (the "wide" cases take no split).
LSE_CASES = {
    "plain": (256, 3, 3, "strided", 2),
    "mask-causal-gqa": (256, 6, 2, "strided", 2),
    "rope": (256, 3, 3, "strided", 2),
    "rope-mask-causal": (256, 3, 3, "strided", 2),
    "one-tile-plain": (128, 3, 3, "strided", 2),
    "one-tile-rope-mask-causal": (128, 3, 3, "strided", 2),
    "mask-causal-gqa7": (512, 14, 2, "strided", 2),
    "plain-contiguous": (256, 3, 3, "contiguous", 2),
    "ring-384-mask-causal-gqa": (384, 6, 2, "strided", 2),
    "ring-640-rope": (640, 3, 3, "strided", 2),
    # the LM's shape, one batch: K4 split 14 ways
    "split-lm-mask-causal-gqa7": (512, 14, 2, "strided", 1),
    "split-rope-mask-causal": (512, 2, 2, "strided", 1),
    # enough 128-row blocks (2 x 36 x 5) for the two-warpgroup forward
    "wide-plain": (640, 36, 36, "strided", 2),
    "wide-rope": (640, 36, 36, "strided", 2),
    "wide-mask-causal-gqa": (640, 36, 12, "strided", 2),
    "wide-rope-mask-causal": (640, 36, 36, "contiguous", 2),
    "wide-ring-384-rope-mask-causal": (384, 24, 24, "strided", 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(LSE_CASES))
def test_flash_lse_and_backward_kernels(dev, d, case):
    """K1 with the lse (exact body), K3 and K4 against their plain
    versions, both backward kernels on the plain forward's residuals. The
    masked cases have a row whose keys are all masked (lse -1e30 +
    log2(S)); the "wide" cases run the forward's two-warpgroup instance
    and K4 without a split."""
    g = torch.Generator(device=dev).manual_seed(7 * d)
    s, hq, hk, layout, b = LSE_CASES[case]
    q, do = (_layout(_randn(g, dev, b, s, hq, d), layout) for _ in range(2))
    k, v = (_layout(_randn(g, dev, b, s, hk, d), layout) for _ in range(2))
    kw = {}
    if "mask" in case:
        mask = torch.arange(s, device=dev)[None] < torch.tensor(
            [[s - 56], [37]][:b], device=dev)
        mask[b - 1, 0] = False
        kw.update(kv_mask=mask, causal=True)
    if "rope" in case:
        kw["rope"] = _tables(s, d, dev)
    before = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    o, lse = tfa.flash_forward_lse(q, k, v, **kw)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    _close(o, o_p)
    assert lse.shape == (b, hq, s) and lse.dtype == torch.float32
    assert (lse - lse_p).abs().max().item() <= 1e-3
    if "mask" in case:
        # row 0 of the last batch sees no valid key: the one-pass body's
        # value
        want = torch.tensor(-1e30 + math.log2(s), device=dev)
        assert bool((lse[b - 1, :, 0] == want).all())
    mask, causal = kw.pop("kv_mask", None), kw.pop("causal", False)
    res = (mask, o_p, lse_p, do, causal)
    for got, want in zip(tfa.flash_backward(q, k, v, *res, **kw),
                         tfa.flash_backward_plain(q, k, v, *res, **kw)):
        _grad_close(got, want)
    after = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {tfa.launch_name(n, d): 1 for n in (
                "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rope", "rope-mask-causal"])
def test_dkv_d256_rope_without_a_split_writes_dk_itself(dev, case):
    """K4 at D = 256 with the rope inside and no split (the ring shard's
    216 blocks of 64 kv rows): the warpgroup that keeps dk holds each
    column's rotation partner and counter-rotates it in registers, so the
    launch allocates no f32 partial sums (its peak is below their bytes:
    the outputs and the rotated Q alone) and launches no reduce kernel;
    dk and dv against the plain version."""
    g = torch.Generator(device=dev).manual_seed(13)
    b, h, s, d = 1, 12, 1152, 256
    q, k, v, do = (_layout(_randn(g, dev, b, s, h, d), "strided")
                   for _ in range(4))
    kw = {"rope": _tables(s, d, dev)}
    if "mask" in case:
        kw.update(kv_mask=torch.arange(s, device=dev)[None] < s - 56,
                  causal=True)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = tfa._delta(o, do)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tfa.dkv_splits(b * h * s // 64, s // 64, sms) == 1
    partial_bytes = 2 * b * h * s * d * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(tfa.DKV_REDUCE_LAUNCHES)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < partial_bytes
    assert tfa.DKV_REDUCE_LAUNCHES == before
    for got, want in zip((dk, dv), tfa.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, **kw)):
        _grad_close(got, want)


def _valid_rows(mask, causal, sq):
    """(B, Sq) bool: rows with at least one valid key."""
    if not causal:
        return mask.any(-1, keepdim=True).expand(-1, sq)
    seen = mask.int().cumsum(-1) > 0
    skv = mask.shape[1]
    return seen[:, :sq] if sq <= skv else torch.cat(
        [seen, seen[:, -1:].expand(-1, sq - skv)], dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["plain", "causal", "mask", "left-pad",
                                  "mask-causal-gqa", "sq>skv", "sq<skv"])
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_chunked_kernel(dev, d, case, with_lse):
    """K2 against its plain version (256 x 512 tiles with the block skip,
    against the kernel's 64 x 64) and against the plain f32 attention, on
    the rows that have a valid key: kv mask, causal mask and its skip, GQA
    6/2, Sq != Skv with the diagonal aligned at row 0, batch 2 on
    (B, S, H, D)-strided views, and the lse within 1e-3 in log2 units."""
    g = torch.Generator(device=dev).manual_seed(3 * d)
    sq, skv = {"sq>skv": (640, 384), "sq<skv": (256, 704)}.get(case,
                                                              (640, 640))
    hq, hk = (6, 2) if "gqa" in case else (3, 3)
    q = _randn(g, dev, 2, sq, hq, d).transpose(1, 2)
    k, v = (_randn(g, dev, 2, skv, hk, d).transpose(1, 2) for _ in range(2))
    kw = {}
    cols = torch.arange(skv, device=dev)[None]
    valid = torch.ones((2, skv), dtype=torch.bool, device=dev)
    if case == "left-pad":
        valid = cols >= torch.tensor([[70], [300]], device=dev)
        kw.update(kv_mask=valid, causal=True)
    elif "mask" in case or "sq" in case:
        valid = cols < torch.tensor([[skv - 50], [37]], device=dev)
        kw["kv_mask"] = valid
    if "causal" in case or "sq" in case:
        kw["causal"] = True
    before = tfa.KERNEL_CHUNKED.launches["flash_chunked"]
    got = tfa.flash_forward_chunked(q, k, v, return_lse=with_lse, **kw)
    assert tfa.KERNEL_CHUNKED.launches["flash_chunked"] == before + 1
    want = tfa.flash_forward_chunked_plain(q, k, v, return_lse=with_lse, **kw)
    rows = _valid_rows(valid, kw.get("causal", False), sq)[:, None, :]
    if with_lse:
        (got, lse), (want, lse_p) = got, want
        assert lse.shape == (2, hq, sq) and lse.dtype == torch.float32
        assert ((lse - lse_p).abs() * rows).max().item() <= 1e-3
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    ref = tfa.xla_attention(q, k, v, **kw)
    for other in (want, ref):
        _close(got * rows[..., None], other * rows[..., None])


# K2's tiling edges: case -> (Sq, Skv, Hq, Hk, kv mask, causal). Its tiles
# are 128 q rows (two warpgroups of 64) by 128 kv rows in a ring of 3
# stages; Sq and Skv are multiples of 64.
CHUNKED_EDGES = {
    "last kv tile of 64 rows": (256, 320, 3, 3, False, False),
    "last kv tile of 64, mask and causal": (320, 320, 3, 3, True, True),
    "last q tile of 64 rows": (320, 640, 3, 3, False, False),
    "one tile of 64": (64, 64, 2, 2, True, False),
    "ring wraps": (256, 1152, 2, 2, False, False),
    "ring wraps, kv mask": (128, 1408, 2, 1, True, False),
    "causal skip, Sq < Skv": (384, 1024, 3, 3, False, True),
    "causal skip, Sq > Skv": (1024, 384, 3, 3, True, True),
    "GQA 7:1, mask, causal": (640, 640, 14, 2, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", list(CHUNKED_EDGES))
def test_flash_chunked_kernel_tiling_edges(dev, d, case):
    """K2 on the edges of its tiling, with the lse: a last kv tile of 64
    rows (zero-filled past Skv), a last q tile of 64 rows (its other
    warpgroup writes nothing), a ring of 3 stages that wraps, the causal
    block skip at Sq != Skv, D = 64 with GQA 7:1; o and the lse of the
    rows that have a valid key against the plain version. Not against the
    plain f32 attention: these masks leave rows of two or three valid keys,
    where p rounded to bf16 before p v (the TPU kernel's rounding point,
    which the plain version keeps) can move o by a bf16 step of |o| (about
    2 here), more than 1e-2, for kernel and plain version alike;
    test_flash_chunked_kernel holds the kernel to the f32 attention."""
    sq, skv, hq, hk, masked, causal = CHUNKED_EDGES[case]
    g = torch.Generator(device=dev).manual_seed(sq + skv + d)
    q = _randn(g, dev, 2, sq, hq, d).transpose(1, 2)
    k, v = (_randn(g, dev, 2, skv, hk, d).transpose(1, 2) for _ in range(2))
    valid = torch.ones((2, skv), dtype=torch.bool, device=dev)
    if masked:
        cols = torch.arange(skv, device=dev)[None]
        valid = (cols < torch.tensor([[skv - 40], [skv // 3]], device=dev)) \
            & (cols >= torch.tensor([[0], [5]], device=dev))
    kw = {"kv_mask": valid if masked else None, "causal": causal}
    before = tfa.KERNEL_CHUNKED.launches["flash_chunked"]
    got, lse = tfa.flash_forward_chunked(q, k, v, return_lse=True, **kw)
    assert tfa.KERNEL_CHUNKED.launches["flash_chunked"] == before + 1
    want, lse_p = tfa.flash_forward_chunked_plain(q, k, v, return_lse=True,
                                                  **kw)
    rows = _valid_rows(valid, causal, sq)[:, None, :]
    assert bool(torch.isfinite(lse).all())
    assert ((lse - lse_p).abs() * rows).max().item() <= 1e-3
    _close(got * rows[..., None], want * rows[..., None])


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["none", "shared", "per-row"])
def test_flash_attention_routes_to_chunked_above_max_kv_seq(dev, norm,
                                                            monkeypatch):
    """Above MAX_KV_SEQ (lowered to 128) ``flash_attention`` runs the norm
    and the rope outside and launches K2 and no K1 variant; through the
    dispatcher an odd length (200 -> 256) reaches K2 with the padded
    mask."""
    monkeypatch.setattr(tfa, "MAX_KV_SEQ", 128)
    g = torch.Generator(device=dev).manual_seed(5)
    s, d = 200, 64
    q, k, v = (_randn(g, dev, 1, s, 2, d) for _ in range(3))
    ids = torch.cat([torch.zeros((s - 64, 3), device=dev),
                     prepare_latent_image_ids(16, 16, dev)])
    rope = flux_rope_freqs_half(ids, (16, 24, 24))
    shape = {"shared": (d,), "per-row": (s, d)}.get(norm)
    qk_norm = None if shape is None else (
        *(1 + 0.1 * torch.randn(shape, generator=g, device=dev)
          for _ in range(2)), 1e-6)
    before = {**tfa.KERNEL.launches, **tfa.KERNEL_CHUNKED.launches}
    got = tattn.attention(q, k, v, rope=rope, qk_norm=qk_norm)
    after = {**tfa.KERNEL.launches, **tfa.KERNEL_CHUNKED.launches}
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]
            } == {"flash_chunked": 1}
    _close(got, tattn.attention(q, k, v, implementation="plain", rope=rope,
                                qk_norm=qk_norm))


@pytest.mark.cuda
def test_gradient_reaches_the_projections_on_the_card(dev):
    """A bf16 DiT (head_dim 64, 64 + 64 joint tokens) on the card: the
    backward runs K1 with the lse, K3 and K4 in every block, every q/k/v
    projection gets a gradient, and the gradient of the text conditioning
    agrees with the plain route's (relative L2 below 5e-2, bf16)."""
    kw = dict(attention_head_dim=64, axes_dims_rope=(16, 24, 24),
              dtype=BF)
    g = torch.Generator(device=dev).manual_seed(2)
    model = random_init_(FluxTransformer2D(
        tiny_flux_config(attention_impl="auto", **kw), dev), g)
    plain = FluxTransformer2D(tiny_flux_config(attention_impl="plain", **kw),
                              dev)
    plain.load_state_dict(model.state_dict())
    args = (_randn(g, dev, 1, 64, 64), _randn(g, dev, 1, 64, 64),
            _randn(g, dev, 1, 32), torch.full((1,), 0.5, device=dev),
            prepare_latent_image_ids(16, 16, dev),
            torch.zeros((64, 3), device=dev))
    w = _randn(g, dev, 1, 64, 64)

    def grad(m):
        txt = args[1].clone().requires_grad_()
        (m(args[0], txt, *args[2:]).float() * w.float()).sum().backward()
        return txt.grad.float()

    before = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    got = grad(model)
    after = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    blocks = 2 + 4
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"flash_fwd_lse": blocks, "flash_bwd_dq": blocks,
                  "flash_bwd_dkv": blocks}
    for blk in [*model.double_blocks, *model.single_blocks]:
        for name in ("q", "k", "v", "img_q", "img_k", "img_v", "txt_q",
                     "txt_k", "txt_v"):
            if hasattr(blk, name):
                grad_w = getattr(blk, name).weight.grad
                assert grad_w is not None and grad_w.abs().sum() > 0
    want = grad(plain)
    assert ((got - want).norm() / want.norm()).item() < 5e-2


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
@pytest.mark.parametrize("tiles,s", [(1, 1025), (2, 1025), (3, 129)],
                         ids=["1 tile", "2 tiles", "129 tokens"])
def test_vit_pad_route_on_the_kernel(dev, tiles, s):
    """InternViT's attention: 16 heads x 64, non-causal, no rope and no
    mask, at 1025 tokens (a 448 tile's CLS and 32 x 32 patches) padded to
    1152 with 127 masked keys, a batch of tiles, and at 129 (one valid
    key in the last tile): one launch of K1's exact body, the padded q
    rows sliced off."""
    g = torch.Generator(device=dev).manual_seed(s + tiles)
    q, k, v = (_randn(g, dev, tiles, s, 16, 64) for _ in range(3))
    before = dict(tfa.KERNEL.launches)
    got = tattn.attention(q, k, v)
    assert tfa.KERNEL.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert got.shape == q.shape
    _close(got, tattn.attention(q, k, v, implementation="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [(1024,), (1024, 600), (600, 7)],
                         ids=["one slice", "1024 and 600 patches",
                              "600 and 7 patches"])
def test_resampler_pad_route_on_the_kernel(dev, lengths):
    """MiniCPM-o's resampler attention: 64 queries (28 heads x 128, the
    same rows for every slice, as the resampler expands them) on each
    slice's patches, non-causal, the patch mask on the keys: the pad
    route gives q 128 rows and the keys a multiple of 128, masked keys
    inside a kv tile where a slice is shorter than the batch's longest;
    one launch of K1's exact body, the padded q rows sliced off. Slices
    of 600 patches and more within the K1 bars of the plain version.
    Every slice, a 7-patch one included (its outputs average few values
    and are several times larger, so that K1's absolute bar is below one
    bf16 step of them), within twice the plain version's distance from
    an f32 reference, plus 1e-3 at the worst element and 1e-4 on
    average."""
    g = torch.Generator(device=dev).manual_seed(sum(lengths))
    n, skv = len(lengths), max(lengths)
    q = _randn(g, dev, 1, 64, 28, 128).expand(n, 64, 28, 128)
    k, v = (_randn(g, dev, n, skv, 28, 128) for _ in range(2))
    mask = (torch.arange(skv, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None])
    before = dict(tfa.KERNEL.launches)
    got = tattn.attention(q, k, v, kv_mask=mask)
    assert tfa.KERNEL.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert got.shape == q.shape
    want = tattn.attention(q, k, v, kv_mask=mask, implementation="plain")
    long = torch.tensor(lengths, device=dev) >= 600
    _close(got[long], want[long])
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))
    s = (qt @ kt.transpose(-1, -2) / 128 ** 0.5).masked_fill(
        ~mask[:, None, None, :], float("-inf"))
    ref = (s.softmax(-1) @ vt).transpose(1, 2)
    for i in range(n):
        err, base = ((t[i].float() - ref[i]).abs() for t in (got, want))
        assert err.max() <= 2 * base.max() + 1e-3
        assert err.mean() <= 2 * base.mean() + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["CLIP 257 tokens", "512 pipelined",
                                  "256 causal GQA", "200 rope + qk norm"])
def test_f32_instance_on_the_card(dev, case):
    """K1's f32 instance through the dispatcher under "auto", f32 in and
    out: the CLIP tower's 257 tokens on the pad route (127 masked keys,
    the exact body), 512 tokens with no mask (the pipelined body), 256
    causal tokens on 8 q / 2 kv heads x 128, and 200 tokens with rope and
    per-row qk norm (inside: the rope-and-norm instance): one launch each,
    within the bf16 bars of the f32 plain version (q, k, v and p are
    rounded to bf16 on the card). Under autograd the same call takes K1's
    f32 instance with the lse, then K3's and K4's (the rope rotated
    outside)."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    s, hq, hk, d = {"CLIP 257 tokens": (257, 16, 16, 64),
                    "512 pipelined": (512, 4, 4, 64),
                    "256 causal GQA": (256, 8, 2, 128),
                    "200 rope + qk norm": (200, 2, 2, 64)}[case]
    q = torch.randn((2, s, hq, d), generator=g, device=dev)
    k, v = (torch.randn((2, s, hk, d), generator=g, device=dev)
            for _ in range(2))
    kw = {"causal": case.startswith("256")}
    if case.startswith("200"):
        ids = torch.cat([torch.zeros((s - 64, 3), device=dev),
                         prepare_latent_image_ids(16, 16, dev)])
        w = 1 + 0.1 * torch.randn((s, d), generator=g, device=dev)
        kw.update(rope=flux_rope_freqs_half(ids, (16, 24, 24)),
                  qk_norm=(w, w, 1e-6))
    name = "flash_fwd_rope_f32" if "rope" in kw else "flash_fwd_f32"
    before = dict(tfa.KERNEL.launches)
    with torch.no_grad():
        got = tattn.attention(q, k, v, **kw)
    assert tfa.KERNEL.launches == dict(before, **{name: before[name] + 1})
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, tattn.attention(q, k, v, implementation="plain", **kw))
    before = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    leaf = q.clone().requires_grad_()
    if "qk norm" in case:
        # the qk norm inside the kernel is forward-only, as in JAX
        with pytest.raises(RuntimeError, match="has no backward"):
            tattn.attention(leaf, k, v, **kw)
        return
    tattn.attention(leaf, k, v, **kw).sum().backward()
    after = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]
            } == {"flash_fwd_lse_f32": 1, "flash_bwd_dq_f32": 1,
                  "flash_bwd_dkv_f32": 1}
    assert leaf.grad.dtype == torch.float32
    assert bool(torch.isfinite(leaf.grad).all())


def _no_farther(got32, got16, want):
    """The f32 instance's outputs against the f32 plain version's, no
    farther in relative L2 than the bf16 instance's on the same inputs
    rounded to bf16; the f32 outputs rounded to bf16 are the bf16
    instance's bit for bit (the same body on the same rounded operands)."""
    for a, b, w in zip(got32, got16, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert torch.equal(a.to(b.dtype), b)
        wf = w.float()
        assert (a - wf).norm() <= (b.float() - wf).norm()


# case -> (Sq, Skv, q heads, kv heads, kv mask, causal, batch)
F32_CASES = {
    "plain": (256, 256, 3, 3, False, False, 2),
    "mask-causal-gqa": (256, 256, 6, 2, True, True, 2),
    "one-tile": (128, 128, 2, 2, False, False, 1),
    # K4 splits its stages over the grid (few 128-row kv blocks)
    "split-mask-causal-gqa7": (512, 512, 14, 2, True, True, 1),
    "wide": (640, 640, 36, 12, False, False, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(F32_CASES))
def test_f32_lse_and_backward_instances(dev, d, case):
    """K1's f32 instance with the lse and K3's and K4's f32 instances (f32
    q, k, v and do rounded to bf16 on the card, f32 outputs), against their
    f32 plain versions beside the bf16 instances on the rounded inputs
    (``_no_farther``), K3 and K4 on the plain forward's residuals; one
    launch of each, on (B, S, H, D)-strided views."""
    sq, skv, hq, hk, masked, causal, b = F32_CASES[case]
    g = torch.Generator(device=dev).manual_seed(11 * d + sq)

    def f32(*shape):
        return torch.randn(shape, generator=g, device=dev).transpose(1, 2)

    q, do = f32(b, sq, hq, d), f32(b, sq, hq, d)
    k, v = f32(b, skv, hk, d), f32(b, skv, hk, d)
    kw = {}
    if masked:
        kw["kv_mask"] = torch.arange(skv, device=dev)[None] < torch.tensor(
            [[skv - 56], [37]][:b], device=dev)
    if causal:
        kw["causal"] = True
    r16 = [x.to(BF) for x in (q, k, v, do)]
    before = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    got = tfa.flash_forward_lse(q, k, v, **kw)
    after = {**tfa.KERNEL.launches, **tfa.KERNEL_BWD.launches}
    want = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    _no_farther(got, tfa.flash_forward_lse(*r16[:3], **kw), want)
    res = (do, want[1], tfa._delta(want[0], do))
    res16 = (r16[3], *res[1:])
    for fn, plain in ((tfa.flash_bwd_dq, tfa.flash_bwd_dq_plain),
                      (tfa.flash_bwd_dkv, tfa.flash_bwd_dkv_plain)):
        got = fn(q, k, v, *res, **kw)
        got = got if isinstance(got, tuple) else (got,)
        got16 = fn(*r16[:3], *res16, **kw)
        got16 = got16 if isinstance(got16, tuple) else (got16,)
        want_g = plain(q, k, v, *res, **kw)
        _no_farther(got, got16, want_g if isinstance(want_g, tuple)
                    else (want_g,))
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]
            } == {tfa.launch_name("flash_fwd_lse_f32", d): 1}
    for name in ("flash_bwd_dq_f32", "flash_bwd_dkv_f32"):
        name = tfa.launch_name(name, d)
        assert tfa.KERNEL_BWD.launches[name] == before[name] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["plain", "mask-causal-gqa", "sq>skv",
                                  "last tiles of 64"])
@pytest.mark.parametrize("with_lse", [False, True])
def test_f32_chunked_instance(dev, d, case, with_lse):
    """K2's f32 instance against its f32 plain version, beside the bf16
    instance on the rounded inputs (``_no_farther``, on the rows that have
    a valid key): no mask, kv mask + causal + GQA 6/2, Sq > Skv, a last q
    and kv tile of 64 rows; one launch, (B, S, H, D)-strided views."""
    sq, skv = {"sq>skv": (640, 384), "last tiles of 64": (320, 576)}.get(
        case, (640, 640))
    hq, hk = (6, 2) if "gqa" in case else (3, 3)
    g = torch.Generator(device=dev).manual_seed(5 * d + sq)
    q = torch.randn((2, sq, hq, d), generator=g, device=dev).transpose(1, 2)
    k, v = (torch.randn((2, skv, hk, d), generator=g,
                        device=dev).transpose(1, 2) for _ in range(2))
    kw, rows = {}, torch.ones((2, 1, sq), dtype=torch.bool, device=dev)
    if case != "plain":
        valid = torch.arange(skv, device=dev)[None] < torch.tensor(
            [[skv - 50], [skv // 3]], device=dev)
        kw.update(kv_mask=valid, causal=True)
        rows = _valid_rows(valid, True, sq)[:, None, :]
    before = tfa.KERNEL_CHUNKED.launches["flash_chunked_f32"]
    got = tfa.flash_forward_chunked(q, k, v, return_lse=with_lse, **kw)
    assert tfa.KERNEL_CHUNKED.launches["flash_chunked_f32"] == before + 1
    got16 = tfa.flash_forward_chunked(*(x.to(BF) for x in (q, k, v)),
                                      return_lse=with_lse, **kw)
    want = tfa.flash_forward_chunked_plain(q, k, v, return_lse=with_lse,
                                           **kw)
    if not with_lse:
        got, got16, want = (got,), (got16,), (want,)
    keep = [rows[..., None], rows]
    _no_farther(*([x * m for x, m in zip(o, keep)]
                  for o in (got, got16, want)))


@pytest.mark.cuda
def test_internvit_kernel_route_on_the_card(dev):
    """A 2-block InternViT at head_dim 64 (17 tokens padded to 128) in
    bf16: one K1 launch per block, and the stack within the bf16 bar of
    the plain attention's (relative L2 at most 2e-2)."""
    import dataclasses

    from x2i_torch.core.config import InternViTConfig
    from x2i_torch.models.internvl import InternViT
    cfg = InternViTConfig(hidden_size=128, intermediate_size=256,
                          num_hidden_layers=2, num_attention_heads=2,
                          image_size=28, patch_size=7)
    g = torch.Generator(device=dev).manual_seed(3)
    vit = random_init_(InternViT(cfg, dev), g)
    plain = InternViT(dataclasses.replace(cfg, attention_impl="plain"), dev)
    plain.load_state_dict(vit.state_dict())
    px = torch.randn((2, 28, 28, 3), generator=g, device=dev)
    before = tfa.KERNEL.launches["flash_fwd"]
    with torch.inference_mode():
        got = vit(px).float()
        assert tfa.KERNEL.launches["flash_fwd"] == before + 2
        want = plain(px).float()
    assert bool(torch.isfinite(got).all())
    assert ((got - want).norm() / want.norm()).item() <= 2e-2


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(dev):
    # bf16 and f32 (its own instances); no other dtype, no mix of the two
    q = torch.zeros((1, 2, 128, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 128, 64), device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, q.to(BF), q)
    # the f32 instances with the lse take no rope inside
    rope = (torch.ones((128, 64), device=dev), torch.zeros((128, 64),
                                                           device=dev))
    with pytest.raises(ValueError, match="no rope"):
        tfa.flash_forward_lse(q, q, q, rope=rope)
    q = torch.zeros((1, 2, 96, 64), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention(q, q, q)                 # 96 % 64 != 0
    q = torch.zeros((1, 2, 192, 64), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention(q, q, q)                 # 192 % 128 != 0
    q = torch.zeros((1, 2, 128, 32), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention(q, q, q)                 # head dim 32
    # K3 and K4 take Sq and Skv in multiples of 128 only
    for sq, skv in ((192, 128), (128, 192)):
        q = torch.zeros((1, 2, sq, 64), device=dev, dtype=BF)
        k = torch.zeros((1, 2, skv, 64), device=dev, dtype=BF)
        rows = torch.zeros((1, 2, sq), device=dev)
        for fn in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
            with pytest.raises(ValueError, match="unsupported"):
                fn(q, k, k, q, rows, rows)


# K1's D = 64 grid instances on the edges of their tiling: case -> (batch,
# q heads, S, valid keys, causal). InternViT-300M's 1152 rows (1025 valid
# keys: a partly masked last kv tile) and CLIP ViT-L/14's 4 x 384 (257),
# which the rule sends to the 64-row instance at three blocks an SM (kv
# tiles of 64 in rings of 4 stages that wrap); 128 rows, the shortest
# sequence (one kv tile of 128, two of 64), with a row whose keys are all
# masked under the causal mask.
D64_GRID_CASES = {
    "ViT 1152, 1025 keys": (1, 16, 1152, 1025, False),
    "CLIP 4 x 384, 257 keys": (4, 16, 384, 257, False),
    "128 rows, mask, causal": (2, 3, 128, 100, True),
    "640 rows, mask, causal, GQA": (2, 6, 640, 600, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("instance", [i[1:] for i in tfa.FWD_INSTANCES
                                      if i[0] == 64])
@pytest.mark.parametrize("case", list(D64_GRID_CASES))
def test_flash_d64_grid_instances(dev, monkeypatch, case, instance):
    """K1b and K1-lse at D = 64 on each grid instance (the rule replaced
    for the call), (B, H, S, D) views of (B, S, H, D) storage: within the
    bf16 bars of the plain version, the lse within 1e-3, a row with no
    valid key the mean of V; the rule's own choice at the two vision
    towers' shapes is the 64-row instance at three blocks an SM, which the
    card holds three at a time."""
    b, hq, s, valid, causal = D64_GRID_CASES[case]
    hk = hq // 3 if "GQA" in case else hq
    g = torch.Generator(device=dev).manual_seed(s + hq)
    q = _randn(g, dev, b, s, hq, 64).transpose(1, 2)
    k, v = (_randn(g, dev, b, s, hk, 64).transpose(1, 2) for _ in range(2))
    mask = (torch.arange(s, device=dev)[None] < valid).expand(b, s).clone()
    if causal:
        mask[-1, 0] = False
    kw = dict(kv_mask=mask, causal=causal)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms == 132 and case.startswith(("ViT", "CLIP")):
        assert tfa.fwd_instance(b, hq, s, 64, sms) == (1, 3)
    assert tfa.fwd_blocks_per_sm(64, *instance) == instance[1]
    monkeypatch.setattr(tfa, "fwd_instance", lambda *a: instance)
    before = tfa.KERNEL.launches["flash_fwd"]
    got = tfa.flash_attention(q, k, v, **kw)
    assert tfa.KERNEL.launches["flash_fwd"] == before + 1
    _close(got, tfa.flash_attention_plain(q, k, v, **kw))
    o, lse = tfa.flash_forward_lse(q, k, v, **kw)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    _close(o, o_p)
    assert (lse - lse_p).abs().max().item() <= 1e-3
    if causal:
        mean_v = v[-1].float().mean(dim=1).repeat_interleave(hq // hk, 0)
        assert (got[-1, :, 0].float() - mean_v).abs().max() <= 1e-2


# head dim 256 in the forward kernels: case -> (S, q heads, kv heads, what
# the call takes). K1's kv tiles are 64 rows in a ring of 2 stages at
# D = 256; 2 x 9 x 12 128-row blocks take the two-warpgroup instance, the
# smaller grids the 64-row one.
D256_CASES = {
    "rope, per-row norm, small grid": (256, 2, 2, "rope-row"),
    "rope, shared norm, wide grid": (1152, 12, 12, "rope-shared"),
    "rope only, one kv tile": (128, 2, 2, "rope"),
    "no rope, pipelined": (512, 4, 4, "plain"),
    "mask, causal, GQA 6:2": (384, 6, 2, "mask-causal"),
    "mask, causal, GQA 6:2, wide grid": (1152, 12, 4, "mask-causal"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(D256_CASES))
def test_flash_d256_kernel(dev, case):
    """K1 at head dim 256, batch 2 on (B, S, H, D)-strided views: K1a with
    the per-row and the shared qk norm (the pipelined body; the exact one
    at one kv tile), K1c and K1b (kv mask, causal, GQA), each against its
    plain version within the bf16 bars, one launch of its ``_d256``
    count; with the lse (K1's training forward, the exact body, the rope
    without the norm) within the same bars and its lse within 1e-3."""
    s, hq, hk, what = D256_CASES[case]
    d = 256
    g = torch.Generator(device=dev).manual_seed(s + hq)
    q = _randn(g, dev, 2, s, hq, d).transpose(1, 2)
    k, v = (_randn(g, dev, 2, s, hk, d).transpose(1, 2) for _ in range(2))
    kw = {}
    if what.startswith("rope"):
        ids = torch.cat([torch.zeros((s - 64, 3), device=dev),
                         prepare_latent_image_ids(16, 16, dev)])
        kw["rope"] = flux_rope_freqs_half(ids, (32, 112, 112))
        shape = {"rope-row": (s, d), "rope-shared": (d,)}.get(what)
        if shape is not None:
            kw["qk_norm"] = (*(1 + 0.1 * torch.randn(shape, generator=g,
                                                     device=dev)
                               for _ in range(2)), 1e-6)
    elif what == "mask-causal":
        kw["kv_mask"] = torch.arange(s, device=dev)[None] < torch.tensor(
            [[s - 56], [37]], device=dev)
        kw["causal"] = True
    name = ("flash_fwd_rope" if "rope" in kw else "flash_fwd"
            if tfa.is_exact(kw.get("kv_mask"), kw.get("causal", False), s)
            else "flash_fwd_pipe") + "_d256"
    before = dict(tfa.KERNEL.launches)
    got = tfa.flash_attention(q, k, v, **kw)
    assert tfa.KERNEL.launches == dict(before, **{name: before[name] + 1})
    _close(got, tfa.flash_attention_plain(q, k, v, **kw))
    # with the lse (the training forward, no qk norm inside): the exact
    # body, its lse
    kw.pop("qk_norm", None)
    o, lse = tfa.flash_forward_lse(q, k, v, **kw)
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    _close(o, o_p)
    assert (lse - lse_p).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "mask", "causal GQA 6:2",
                                  "last q tile of 64", "ring wraps, mask"])
def test_flash_chunked_d256_kernel(dev, case):
    """K2 at head dim 256 (64-row kv tiles in a ring of 2 stages, the kv
    mask as two ballots of two keys a lane), batch 2 on strided views:
    against its plain version and the plain f32 attention on the rows that
    have a valid key, one launch of ``flash_chunked_d256``; with the lse
    the same o and the plain version's lse within 1e-3 on those rows. The
    bar is ``_close``'s, with one bf16 step of |o| on
    top at each element: under the causal mask the first rows average a
    few keys, so |o| reaches 2-4, where a bf16 step is 2^-6 (an output
    rounded on the other side, or p rounded to bf16 against the f32
    attention's p, moves it by one)."""
    d = 256
    sq, skv, hq, hk = {"causal GQA 6:2": (640, 640, 6, 2),
                       "last q tile of 64": (320, 640, 3, 3),
                       "ring wraps, mask": (128, 1408, 2, 1)}.get(
        case, (640, 640, 3, 3))
    g = torch.Generator(device=dev).manual_seed(sq + skv)
    q = _randn(g, dev, 2, sq, hq, d).transpose(1, 2)
    k, v = (_randn(g, dev, 2, skv, hk, d).transpose(1, 2) for _ in range(2))
    valid = torch.ones((2, skv), dtype=torch.bool, device=dev)
    kw = {}
    if "mask" in case:
        cols = torch.arange(skv, device=dev)[None]
        valid = (cols < torch.tensor([[skv - 40], [skv // 3]], device=dev)) \
            & (cols >= torch.tensor([[0], [5]], device=dev))
        kw["kv_mask"] = valid
    if "causal" in case:
        kw["causal"] = True
    before = dict(tfa.KERNEL_CHUNKED.launches)
    got = tfa.flash_forward_chunked(q, k, v, **kw)
    assert tfa.KERNEL_CHUNKED.launches == dict(
        before, flash_chunked_d256=before["flash_chunked_d256"] + 1)
    rows = _valid_rows(valid, kw.get("causal", False), sq)[:, None, :, None]
    for other in (tfa.flash_forward_chunked_plain(q, k, v, **kw),
                  tfa.xla_attention(q, k, v, **kw)):
        want = (other * rows).float()
        diff = (got * rows).float() - want
        assert bool(torch.isfinite(got).all())
        assert bool((diff.abs() <= 1e-2 + 2.0 ** -7 * want.abs()).all())
        assert diff.abs().mean().item() <= 1e-3
    o_l, lse = tfa.flash_forward_chunked(q, k, v, return_lse=True, **kw)
    _, lse_p = tfa.flash_forward_chunked_plain(q, k, v, return_lse=True,
                                               **kw)
    assert torch.equal(o_l, got)
    assert ((lse - lse_p).abs() * rows[..., 0]).max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", ["per-row norm", "shared norm", "rope only",
                                  "pad route, mask"])
def test_f32_rope_norm_instance(dev, d, case):
    """K1's f32 rope-and-norm instance (f32 q, k, v, o; the rope and the
    qk norm inside, with the bf16 K1a's rounding points on the inputs
    rounded to bf16): o rounded to bf16 is the bf16 K1a's on the rounded
    inputs bit for bit, and no farther from the f32 plain version in
    relative L2; one launch of ``flash_fwd_rope_f32`` (``_d256`` at 256).
    The pad route (200 tokens padded to 256, masked keys) takes its exact
    body."""
    s = 200 if case.startswith("pad") else 512
    g = torch.Generator(device=dev).manual_seed(d + s + len(case))
    q, k, v = (torch.randn((2, s, 2, d), generator=g, device=dev)
               for _ in range(3))
    axes = {64: (16, 24, 24), 128: (16, 56, 56), 256: (32, 112, 112)}[d]
    ids = torch.cat([torch.zeros((s - 64, 3), device=dev),
                     prepare_latent_image_ids(16, 16, dev)])
    kw = {"rope": flux_rope_freqs_half(ids, axes)}
    shape = {"per-row norm": (s, d), "shared norm": (d,),
             "pad route, mask": (s, d)}.get(case)
    if shape is not None:
        kw["qk_norm"] = (*(1 + 0.1 * torch.randn(shape, generator=g,
                                                 device=dev)
                           for _ in range(2)), 1e-6)
    name = tfa.launch_name("flash_fwd_rope_f32", d)
    with torch.no_grad():
        before = dict(tfa.KERNEL.launches)
        got = tattn.attention(q, k, v, **kw)
        assert tfa.KERNEL.launches == dict(before,
                                           **{name: before[name] + 1})
        got16 = tattn.attention(*(t.to(BF) for t in (q, k, v)), **kw)
        want = tattn.attention(q, k, v, implementation="plain", **kw)
    _no_farther([got], [got16], [want])


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
    # bf16 and f32 (its own instance); no other dtype
    with pytest.raises(ValueError, match="bf16 or f32"):
        tfg.ln_mod(x.half(), shift.half(), scale.half())


def _rows(g, dev, *shape, mean=3.0):
    """Rows x * sigma + mu, sigma per row over four decades."""
    lead = (*shape[:-1], 1)
    sigma = 10.0 ** (4 * torch.rand(lead, generator=g, device=dev) - 2)
    mu = mean * sigma * torch.randn(lead, generator=g, device=dev)
    return (torch.randn(shape, generator=g, device=dev) * sigma + mu).to(BF)


def _codes_close(got, want, flips):
    d = (got[0].int() - want[0].int()).abs()
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    assert got[1].shape == want[1].shape
    assert d.max().item() <= 1
    assert (d != 0).float().mean().item() <= flips


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 300])
@pytest.mark.parametrize("batch", [1, 2])
def test_ln_mod_quant_kernel(dev, rows, batch):
    g = torch.Generator(device=dev).manual_seed(rows + batch)
    x = _rows(g, dev, batch, rows, 3072)
    mod = _randn(g, dev, batch, 6 * 3072)
    shift, scale = mod[:, :3072], mod[:, 3072:6144]
    before = tfg.LAUNCHES["ln_mod_quant"]
    got = tfg.ln_mod_quant(x, shift, scale)
    assert tfg.LAUNCHES["ln_mod_quant"] == before + 1
    want = tfg.ln_mod_quant_plain(x, shift, scale)
    _codes_close(got, want, 0.01)
    rel = (got[1] - want[1]).abs() / want[1]
    assert rel.max().item() <= 2.0 ** -7
    # bf16 and f32 (its own instance); no other dtype
    with pytest.raises(ValueError, match="bf16 or f32"):
        tfg.ln_mod_quant(x.half(), shift.half(), scale.half())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 300, 12288), (4, 3072), (1, 64)])
def test_gelu_and_quant_rows_kernels(dev, shape):
    """(B, S, D) and the (N, D) rows of the unfused layers' inputs."""
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = _rows(g, dev, *shape, mean=0.0)
    before = dict(tfg.LAUNCHES)
    got = tfg.gelu_quant(x)
    _codes_close(got, tfg.gelu_quant_plain(x), 0.10)
    torch.testing.assert_close(got[1], tfg.gelu_quant_plain(x)[1],
                               rtol=2e-2, atol=0)
    q, a = tfg.quant_rows(x)
    q_plain, a_plain = tfg.quant_rows_plain(x)
    assert torch.equal(q, q_plain) and torch.equal(a, a_plain)
    assert tfg.LAUNCHES["gelu_quant"] == before["gelu_quant"] + 1
    assert tfg.LAUNCHES["quant_rows"] == before["quant_rows"] + 1


# K5 (csrc/row_glue.cu): (B, S, D). The grid holds no more blocks than fit
# on the card (one or two an SM at D = 3072, eight of the generic
# instance), each taking a contiguous span of rows at eight rows in
# progress: above a few thousand rows a warp walks several rows of its
# span, and past batch boundaries where B is large and S small.
LN_MOD_CASES = {
    "B 2, odd S, spans cross the batch": (2, 2305, 3072),
    "B 300, S 7, spans cross two batches": (300, 7, 3072),
    "B 3, odd S, one row a warp": (3, 257, 3072),
    "1 row": (1, 1, 3072),
    "4608 rows": (1, 4608, 3072),
    "generic D 64, long spans": (3, 9001, 64),
    "generic D 64, 1 row": (1, 1, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LN_MOD_CASES))
def test_ln_mod_kernel_spans(dev, case):
    """K5 at D = 3072 (and its generic instance) against the plain
    version, on strided chunk(6) modulation rows: the normalized row
    within one bf16 step, its modulate bit for bit."""
    b, s, d = LN_MOD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(s + d)
    x = _rows(g, dev, b, s, d)
    mod = _randn(g, dev, b, 6 * d)
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    zero = torch.zeros_like(shift)
    got = tfg._ln_mod_cuda(x, shift, scale, 1e-6)
    y = tfg._ln_mod_cuda(x, zero, zero, 1e-6)
    y_plain = tfg.ln_mod_plain(x, zero, zero)
    tol = 2.0 ** -7 * y_plain.float().abs() + 1e-4
    assert bool(((y.float() - y_plain.float()).abs() <= tol).all())
    assert torch.equal(got, y * (1.0 + scale[:, None]) + shift[:, None])


# K5's f32 instances: case -> (B, S, D). f32_rows_kernel, K6's group of
# threads a row (a block a row from D = 1024 on), 4 or 16 chunks a thread
# in registers, past 16384 the rest read again from memory
LN_MOD_F32_CASES = {
    "4608 rows": (1, 4608, 3072),
    "4096 rows": (1, 4096, 3072),
    "512 rows": (1, 512, 3072),
    "B 2, odd S, spans cross the batch": (2, 2305, 3072),
    "1 row": (1, 1, 3072),
    "D 64": (3, 257, 64),
    "D 1028, a partial last chunk": (2, 33, 1028),
    "D 3076, the first wide row": (2, 33, 3076),
    "D 4096, 4608 rows": (1, 4608, 4096),
    "D 6144, B 3, spans cross the batch": (3, 700, 6144),
    "D 16388, chunks read again": (2, 5, 16388),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LN_MOD_F32_CASES))
def test_ln_mod_f32_kernel(dev, case):
    """K5 on f32 rows (f32_rows_kernel) against the plain version
    in f32, on strided chunk(6) modulation rows and rows whose scale spans
    four decades: within 1e-5 relative and absolute (the row statistics
    are f32 sums in another order); one launch of ``ln_mod_f32``. f16 is
    refused."""
    b, s, d = LN_MOD_F32_CASES[case]
    g = torch.Generator(device=dev).manual_seed(s + d)
    x = _rows(g, dev, b, s, d).float()
    mod = torch.randn((b, 6 * d), generator=g, device=dev) * 0.5
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    before = dict(tfg.LAUNCHES)
    got = tfg.ln_mod(x, shift, scale)
    assert tfg.LAUNCHES == dict(before, ln_mod_f32=before["ln_mod_f32"] + 1)
    assert got.dtype == torch.float32 and got.shape == x.shape
    torch.testing.assert_close(got, tfg.ln_mod_plain(x, shift, scale),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tfg.ln_mod(x.half(), shift.half(), scale.half())


def _tie_rows(g, dev, n, d):
    """Rows of (2k + 1) / 16, k in [-127, 126], each with one +-15.875: the
    scale is 2^-3 and every quotient is k + 0.5 (round half to even)."""
    k = torch.randint(-127, 127, (n, d), generator=g, device=dev)
    x = (2 * k + 1).float() / 16
    at = torch.randint(0, d, (n,), generator=g, device=dev)
    sign = torch.randint(0, 2, (n,), generator=g, device=dev) * 2 - 1
    x[torch.arange(n, device=dev), at] = 15.875 * sign
    return x.to(BF)


# K7 (csrc/row_glue.cu): x's shape. D = 12288 takes the ring kernel, the
# other widths the generic one. The grid holds no more blocks than fit on
# the card (four an SM at D = 12288, eight of the generic instance), one
# row in progress each: above about 1100 rows (D = 12288) a block walks
# three rows or more and its ring of two rows wraps, past batch boundaries
# where B > 1.
GELU_QUANT_CASES = {
    "1 row": (1, 1, 12288),
    "300 rows": (1, 300, 12288),
    "4608 rows": (1, 4608, 12288),
    "ring wraps, batch 2": (2, 1501, 12288),
    "ring wraps, B 700, S 3": (700, 3, 12288),
    "generic (4, 3072)": (4, 3072),
    "generic (1, 64)": (1, 64),
    "generic, long spans": (3, 1201, 3072),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GELU_QUANT_CASES))
def test_gelu_quant_kernel_rows(dev, case):
    """K7 against its plain version at the JAX package's bar: codes within
    one step, at most 10% flipped, scales within rtol 2e-2."""
    shape = GELU_QUANT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = _rows(g, dev, *shape, mean=0.0)
    got = tfg._gelu_quant_cuda(x)
    want = tfg.gelu_quant_plain(x)
    _codes_close(got, want, 0.10)
    torch.testing.assert_close(got[1], want[1], rtol=2e-2, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["rows", "tie rows"])
@pytest.mark.parametrize("case", list(GELU_QUANT_CASES))
def test_gelu_quant_identity_instance_is_exact(dev, case, ties):
    """K7's quantization epilogue (one reciprocal per row, Markstein's
    correction, rounding by adding 1.5 * 2^23) without the gelu, which is
    K8 (the ring kernel at D = 12288, the warp body at 3072, the generic
    kernel at 64): bit for bit the plain quantization, codes and scales,
    on rows over four decades and on rows where every quotient is a tie.
    It counts one K8 launch."""
    shape = GELU_QUANT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(sum(shape) + ties)
    if ties:
        x = _tie_rows(g, dev, math.prod(shape[:-1]), shape[-1]).view(shape)
    else:
        x = _rows(g, dev, *shape)
    before = dict(tfg.LAUNCHES)
    q, a = tfg.quant_rows(x)
    q_plain, a_plain = tfg.quant_rows_plain(x)
    assert torch.equal(q, q_plain) and torch.equal(a, a_plain)
    assert tfg.LAUNCHES == dict(before, quant_rows=before["quant_rows"] + 1)


# K8's halves at a member's row-split widths of the sharded DiT (4
# members: 768, 3072, 3840), on a whole row of 4 members' blocks; the
# image and text rows of the double block's attention output; a width of
# 3 chunks, spans across batches
ROW_HALVES_CASES = {
    "attention (1, 4608, 768)": (1, 4608, 768),
    "mlp_out (1, 4096, 3072)": (1, 4096, 3072),
    "single out (1, 4608, 3840)": (1, 4608, 3840),
    "generic D 24, B 3": (3, 1001, 24),
    "B 300, S 7, 3072": (300, 7, 3072),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["rows", "tie rows"])
@pytest.mark.parametrize("case", list(ROW_HALVES_CASES))
def test_row_absmax_and_quant_rows_at_are_exact(dev, case, ties):
    """K8's halves on each of 4 members' blocks of a row: ``row_absmax``
    and ``quant_rows_at`` at the members' maximum bit for bit their plain
    versions, each counted once a call, and the members' codes and scales
    together bit for bit whole-row K8's; a non-contiguous block (a view of
    the whole row) too."""
    shape = ROW_HALVES_CASES[case]
    whole_shape = (*shape[:-1], 4 * shape[-1])
    g = torch.Generator(device=dev).manual_seed(sum(shape) + 11 * ties)
    if ties:
        whole = _tie_rows(g, dev, math.prod(shape[:-1]),
                          whole_shape[-1]).view(whole_shape)
    else:
        whole = _rows(g, dev, *whole_shape)
    views = list(whole.split(shape[-1], -1))
    parts = [t.contiguous() for t in views]
    before = dict(tfg.LAUNCHES)
    amaxes = [tfg.row_absmax(x) for x in parts]
    assert tfg.LAUNCHES == dict(before, row_absmax=before["row_absmax"] + 4)
    for a, x in zip(amaxes, parts):
        assert torch.equal(a, tfg.row_absmax_plain(x))
    amax = torch.stack(amaxes).amax(0)
    q_whole, a_whole = tfg.quant_rows(whole)
    codes = []
    for x, view in zip(parts, views):
        q, a = tfg.quant_rows_at(x, amax)
        qp, ap = tfg.quant_rows_at_plain(x, amax)
        assert torch.equal(q, qp) and torch.equal(a, ap)
        assert torch.equal(a, a_whole)
        qv, _ = tfg.quant_rows_at(view, amax)
        assert torch.equal(qv, q)
        codes.append(q)
    assert torch.equal(torch.cat(codes, -1), q_whole)
    assert torch.equal(tfg.row_absmax(views[1]), amaxes[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 768, 3072), (512, 3072, 3072),
                                   (4608, 3840, 3072), (5, 64, 64)])
def test_acc_gemms_on_member_products(dev, m, k, n):
    """The int8 and w4a8 GEMMs' int32-out instances at a member's
    row-split products (w4a8 on a weight quantized at the member's own
    width, as its shard is packed) exact, each counted under its own
    name."""
    from x2i_torch.ops.quant import quantize_kernel_w4a8
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    xq, _, w, _, _ = _gemm_inputs(g, dev, m, k, n)
    before = dict(tgemm.GEMM.launches)
    assert torch.equal(tgemm.int8_matmul_acc(xq, w),
                       tgemm.int8_matmul_acc_plain(xq, w))
    wf = torch.randn((n, k), generator=g, device=dev) / k ** 0.5
    pk, ms, _ = quantize_kernel_w4a8(wf.t(), 32 if k == 64 else 128)
    pw = pk.t().contiguous()
    assert torch.equal(t4.w4a8_matmul_acc(xq, pw, ms),
                       t4.w4a8_matmul_acc_plain(xq, pw, ms))
    assert tgemm.GEMM.launches == dict(
        before, int8_gemm_acc=before["int8_gemm_acc"] + 1,
        w4a8_gemm_acc=before["w4a8_gemm_acc"] + 1)


# K8 (csrc/row_glue.cu) at every width of the w8a8 path: the unfused
# layers' inputs (x_embedder 64, context_embedder 4096, the time and
# pooled embedders 256 and 768, the mods pass and norm_out 3072), the
# attention outputs (3072: the warp body; the double block's image and
# text slices of one (1, 4608, 3072) tensor) and the MLP width 12288 (the
# ring kernel); spans that cross batches, a width of 3 chunks
QUANT_ROWS_CASES = {
    "x_embedder (1, 4096, 64)": (1, 4096, 64),
    "context_embedder (1, 512, 4096)": (1, 512, 4096),
    "time in (1, 256)": (1, 256),
    "pooled in (1, 768)": (1, 768),
    "mods pass (4, 3072)": (4, 3072),
    "attention (1, 4608, 3072)": (1, 4608, 3072),
    "B 2, odd S, 3072": (2, 2305, 3072),
    "B 300, S 7, 3072": (300, 7, 3072),
    "1 row, 3072": (1, 1, 3072),
    "mlp (1, 300, 12288)": (1, 300, 12288),
    "generic D 24, B 3": (3, 1001, 24),
    # the int8 7B LM's decode rows: its width and its MLP's
    "decode row, 3584": (1, 1, 3584),
    "decode row, 18944": (1, 1, 18944),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["rows", "tie rows"])
@pytest.mark.parametrize("case", list(QUANT_ROWS_CASES))
def test_quant_rows_kernel_is_exact(dev, case, ties):
    """K8 bit for bit the plain quantization, codes and scales, with its
    counter stepping by one per call; at D = 3072 the generic kernel (the
    warp body's alternative) too, at a warp and at a block a row, and the
    image and text slices of the double block's attention output."""
    shape = QUANT_ROWS_CASES[case]
    g = torch.Generator(device=dev).manual_seed(sum(shape) + 7 * ties)
    if ties:
        x = _tie_rows(g, dev, math.prod(shape[:-1]), shape[-1]).view(shape)
    else:
        x = _rows(g, dev, *shape)
    inputs = [x]
    if shape == (1, 4608, 3072):
        inputs += [x[:, :512], x[:, 512:]]
    for t in inputs:
        before = tfg.LAUNCHES["quant_rows"]
        q, a = tfg.quant_rows(t)
        assert tfg.LAUNCHES["quant_rows"] == before + 1
        q_plain, a_plain = tfg.quant_rows_plain(t)
        assert q.shape == t.shape and a.shape == (*t.shape[:-1], 1)
        assert torch.equal(q, q_plain) and torch.equal(a, a_plain)
    if shape[-1] == 3072:
        q_plain, a_plain = tfg.quant_rows_plain(x)
        for lanes in (32, 256):
            q, a = tfg._quant_rows_cuda(x, instance=("generic", lanes))
            assert torch.equal(q, q_plain) and torch.equal(a, a_plain)


# K6 (csrc/row_glue.cu): K5's cases. At D = 3072 it is K5's warp body with
# the quantization after it, so it is bit for bit K8 after K5, codes and
# scales; the generic instance likewise.
LN_MOD_QUANT_CASES = {
    "B 2, odd S, spans cross the batch": (2, 2305, 3072),
    "B 300, S 7, spans cross two batches": (300, 7, 3072),
    "1 row": (1, 1, 3072),
    "4608 rows": (1, 4608, 3072),
    "batch 2 at 512": (2, 512, 3072),
    "generic D 64, long spans": (3, 9001, 64),
    "generic D 768, 1 row": (1, 1, 768),
}


@pytest.mark.cuda
@pytest.mark.parametrize("contiguous", [False, True],
                         ids=["chunk(6) rows", "contiguous rows"])
@pytest.mark.parametrize("case", list(LN_MOD_QUANT_CASES))
def test_ln_mod_quant_kernel_is_k8_after_k5(dev, case, contiguous):
    """K6 against its plain version (codes within one step, at most 1%
    flipped, scales within one bf16 step), and bit for bit
    ``quant_rows(ln_mod(x, shift, scale))`` on the card, one launch each,
    on strided chunk(6) modulation rows and on contiguous ones."""
    b, s, d = LN_MOD_QUANT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(b + s + d)
    x = _rows(g, dev, b, s, d)
    mod = _randn(g, dev, b, 6 * d)
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    if contiguous:
        shift, scale = shift.contiguous(), scale.contiguous()
    before = dict(tfg.LAUNCHES)
    got = tfg.ln_mod_quant(x, shift, scale)
    assert tfg.LAUNCHES == dict(before,
                                ln_mod_quant=before["ln_mod_quant"] + 1)
    want = tfg.ln_mod_quant_plain(x, shift, scale)
    _codes_close(got, want, 0.01)
    rel = (got[1] - want[1]).abs() / want[1]
    assert rel.max().item() <= 2.0 ** -7
    q, a = tfg.quant_rows(tfg.ln_mod(x, shift, scale))
    assert torch.equal(got[0], q) and torch.equal(got[1], a)


def _gemm_inputs(g, dev, m, k, n, width=None):
    xq, a = tfg.quant_rows_plain(_rows(g, dev, m, k))
    w = torch.randint(-127, 128, (n, width or k), generator=g, device=dev,
                      dtype=torch.int8)
    scale = (torch.rand(n, generator=g, device=dev) + 0.5) / 127 / 64
    bias = _randn(g, dev, n)
    return xq, a, w, scale, bias


def _bf16_close(got, want):
    assert got.dtype == BF and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 2.0 ** -7 * want.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 3072, 640), (4, 3072, 1152),
                                   (1, 256, 3072), (129, 64, 64)])
def test_int8_gemm_kernel(dev, m, k, n):
    """Ragged M, the M = 4 adaLN rows, M = 1, K = 64 / N = 64 (the DiT's
    x_embedder and proj_out)."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    xq, a, w, scale, bias = _gemm_inputs(g, dev, m, k, n)
    assert torch.equal(tgemm.int8_matmul_acc(xq, w),
                       tgemm.int8_matmul_acc_plain(xq, w))
    before = tgemm.GEMM.launches["int8_gemm"]
    for b in (None, bias):
        got = tgemm.int8_linear(xq, a, w, scale, bias=b)
        _bf16_close(got, tgemm.int8_linear_plain(xq, a, w, scale, bias=b))
    assert tgemm.GEMM.launches["int8_gemm"] == before + 2


@pytest.mark.cuda
def test_int8_gemm_k_offset_chunks(dev):
    """The single block's output layer: two chunks, K-slices of one
    (N, 3072 + 12288)-shaped weight, the second adding the first's bf16
    part and the bias in its epilogue."""
    g = torch.Generator(device=dev).manual_seed(5)
    m, n = 200, 384
    xa, aa, w, scale, bias = _gemm_inputs(g, dev, m, 3072, n, 3072 + 12288)
    xb, ab = tfg.quant_rows_plain(_rows(g, dev, m, 12288))
    assert torch.equal(tgemm.int8_matmul_acc(xb, w, k0=3072),
                       tgemm.int8_matmul_acc_plain(xb, w, k0=3072))
    part = tgemm.int8_linear(xa, aa, w, scale)
    got = tgemm.int8_linear(xb, ab, w, scale, bias=bias, k0=3072,
                            addend=part)
    want_part = tgemm.int8_linear_plain(xa, aa, w, scale)
    assert torch.equal(part, want_part)
    want = tgemm.int8_linear_plain(xb, ab, w, scale, bias=bias, k0=3072,
                                   addend=want_part)
    _bf16_close(got, want)


# the GEMM's tiling edges: case -> (M, K, N, weight width, k0). Its tiles
# are 128 rows by 256 columns, in K steps of 128 bytes through a ring of 4
# stages.
GEMM_EDGES = {
    "M 1": (1, 3072, 6144, None, 0),
    "M 4": (4, 3072, 1152, None, 0),
    "M 65": (65, 768, 640, None, 0),
    "M 4608": (4608, 512, 384, None, 0),
    "N 64": (200, 3072, 64, None, 0),
    "K 64": (300, 64, 512, None, 0),
    "koff chunk": (130, 1024, 264, 4096, 3072),
    "ring wraps at K 12288": (129, 12288, 256, None, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GEMM_EDGES))
def test_int8_gemm_tiling_edges(dev, case):
    """The GEMM on the edges of its tiling: a few rows, a ragged last row
    tile, N and K of 64 (one overhanging tile and K step), a K-slice of a
    wider weight at koff, a ring that wraps 96 times: the int32 sum
    (acc_only) exact, and the bf16 output with the bias within one bf16
    step of the plain version."""
    m, k, n, width, k0 = GEMM_EDGES[case]
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    xq, a, w, scale, bias = _gemm_inputs(g, dev, m, k, n, width)
    before = dict(tgemm.GEMM.launches)
    assert torch.equal(tgemm.int8_matmul_acc(xq, w, k0),
                       tgemm.int8_matmul_acc_plain(xq, w, k0))
    got = tgemm.int8_linear(xq, a, w, scale, bias=bias, k0=k0)
    assert tgemm.GEMM.launches == dict(
        before, int8_gemm=before["int8_gemm"] + 1,
        int8_gemm_acc=before["int8_gemm_acc"] + 1)
    _bf16_close(got, tgemm.int8_linear_plain(xq, a, w, scale, bias=bias,
                                             k0=k0))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 512], ids=["decode", "prefill"])
@pytest.mark.parametrize("k,n", [(3584, 3584), (3584, 512), (3584, 18944),
                                 (18944, 3584)])
def test_int8_gemm_lm_shapes(dev, m, k, n):
    """The int8 7B LM's products (q and o, k and v, gate and up, down) at
    one decode row and at the 512-row prefill."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    xq, a, w, scale, bias = _gemm_inputs(g, dev, m, k, n)
    assert torch.equal(tgemm.int8_matmul_acc(xq, w),
                       tgemm.int8_matmul_acc_plain(xq, w))
    got = tgemm.int8_linear(xq, a, w, scale, bias=bias)
    _bf16_close(got, tgemm.int8_linear_plain(xq, a, w, scale, bias=bias))


@pytest.mark.cuda
def test_int8_lm_decode_step_kernel_route(dev):
    """A tiny w8a8 LM's prefill and decode steps through the int8 GEMM and
    K8 (7 of each a layer a call) against the plain route on the same
    int8 weights, to the two-w8a8-evaluations bar (correlation above
    0.999, relative L2 below 5e-2)."""
    import dataclasses

    from x2i_torch.core.config import tiny_qwen2_config
    from x2i_torch.models.qwen2 import Qwen2LM
    from x2i_torch.ops.quant import quantize_module_

    cfg = tiny_qwen2_config(dtype=BF)
    kern = random_init_(Qwen2LM(cfg, dev), torch.Generator(
        device=dev).manual_seed(0))
    quantize_module_(kern, "w8a8")
    plain = Qwen2LM(dataclasses.replace(kern.cfg, quant_impl="plain"), dev)
    plain.load_state_dict(kern.state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    emb, tok = _randn(g, dev, 2, 24, 64), _randn(g, dev, 2, 1, 64)
    mask = torch.arange(24, device=dev)[None] < torch.tensor(
        [[24], [17]], device=dev)
    kv = torch.nn.functional.pad(mask, (0, 8))
    kv[:, 24] = True
    pos = mask.sum(-1, keepdim=True)
    outs = []
    for lm in (kern, plain):
        before = (tgemm.GEMM.launches["int8_gemm"],
                  tfg.LAUNCHES["quant_rows"])
        cache = lm.init_cache(2, 32)
        pre = lm.prefill_cached(emb, mask, cache)[0]
        step = lm.decode_step(tok, cache, 24, kv, pos)[0]
        outs.append((pre.float(), step.float(), cache[0].float()))
        used = (tgemm.GEMM.launches["int8_gemm"] - before[0],
                tfg.LAUNCHES["quant_rows"] - before[1])
        assert used == ((28, 28) if lm is kern else (0, 0))
    for got, want in zip(*outs):
        rel = ((got - want).norm() / want.norm()).item()
        corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()])
                              )[0, 1].item()
        assert corr > 0.999 and rel < 5e-2, (corr, rel)


@pytest.mark.cuda
def test_int8_gemm_refuses_what_it_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    xq, a, w, scale, _ = _gemm_inputs(g, dev, 8, 128, 64)
    with pytest.raises(ValueError, match="unsupported"):
        tgemm.int8_linear(xq[:, :96], a, w, scale)           # K % 64
    with pytest.raises(ValueError, match="unsupported"):
        tgemm.int8_linear(xq, a, w[:60], scale[:60])         # N % 8
    with pytest.raises(ValueError, match="unsupported"):
        tgemm.int8_linear(xq[:, :64], a, w, scale, k0=8)     # k0 % 16
    with pytest.raises(ValueError, match="bf16 or f32"):
        tgemm.int8_linear(xq, a, w, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="bias must be"):
        tgemm.int8_linear(xq, a, w, scale, bias=torch.zeros(64, device=dev),
                          out_dtype=BF)
    with pytest.raises(ValueError, match="int8"):
        tgemm.int8_linear(xq.float(), a, w, scale)


@pytest.mark.cuda
def test_quantize_kernel_on_the_card_matches_the_cpu(dev):
    """quantize_kernel gives the same codes and scales on the card as on
    the CPU (IEEE divisions on both, round half to even)."""
    from x2i_torch.ops.quant import quantize_kernel
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((3072, 640), generator=g, device=dev) / 3072 ** 0.5
    q, s = quantize_kernel(w)
    q_cpu, s_cpu = quantize_kernel(w.cpu())
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)


def _w4a8_inputs(g, dev, m, k, n, inn, groups):
    xq, a = tfg.quant_rows_plain(_rows(g, dev, m, k))
    pw = torch.randint(-128, 128, (n, inn // 2), generator=g, device=dev,
                       dtype=torch.int8)
    ms = torch.randint(1, 16, (groups, n), generator=g, device=dev,
                       dtype=torch.int8)
    scale = (torch.rand(n, generator=g, device=dev) + 0.5) / 127 / 64 / 8
    return xq, a, pw, ms, scale, _randn(g, dev, n)


# the w4a8 GEMM's edges: case -> (M, K, N, inputs, groups, k0). A packed
# step of 128 bytes at column P gives the K steps of inputs P.. (low
# nibbles) and P + in/2.. (high), through the int8 GEMM's ring of 4.
W4A8_EDGES = {
    "x_embedder: in/2 32, g 32": (300, 64, 512, 64, 2, 0),
    "time in_layer: one packed step": (1, 256, 3072, 256, 2, 0),
    "pooled in_layer: three steps": (1, 768, 640, 768, 6, 0),
    "adaLN rows": (4, 3072, 1152, 3072, 24, 0),
    "M 4608, ring wraps": (4608, 3072, 384, 3072, 24, 0),
    "low half only": (130, 3072, 264, 15360, 120, 0),
    "across the half": (129, 12288, 256, 15360, 120, 3072),
    "high half only": (65, 256, 256, 1024, 8, 640),
    "groups of 48": (70, 96, 64, 96, 2, 0),
    "N 64": (200, 3072, 64, 3072, 24, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(W4A8_EDGES))
def test_w4a8_gemm_edges(dev, case):
    """The int32 sum (acc_only) exact and the bf16 output with the bias
    within one bf16 step of the plain version, each launch counted."""
    m, k, n, inn, groups, k0 = W4A8_EDGES[case]
    g = torch.Generator(device=dev).manual_seed(m + k + n + k0)
    xq, a, pw, ms, scale, bias = _w4a8_inputs(g, dev, m, k, n, inn, groups)
    before = dict(tgemm.GEMM.launches)
    assert torch.equal(t4.w4a8_matmul_acc(xq, pw, ms, k0),
                       t4.w4a8_matmul_acc_plain(xq, pw, ms, k0))
    got = t4.w4a8_linear(xq, a, pw, ms, scale, bias=bias, k0=k0)
    assert tgemm.GEMM.launches == dict(
        before, w4a8_gemm=before["w4a8_gemm"] + 1,
        w4a8_gemm_acc=before["w4a8_gemm_acc"] + 1)
    _bf16_close(got, t4.w4a8_linear_plain(xq, a, pw, ms, scale, bias=bias,
                                          k0=k0))


@pytest.mark.cuda
def test_w4a8_gemm_chunks_add_in_the_epilogue(dev):
    """The single block's output layer in w4a8: the attention chunk (low
    half) and the mlp chunk across the half of one 15360-wide weight, the
    second adding the first's bf16 part and the bias."""
    g = torch.Generator(device=dev).manual_seed(9)
    m, n = 200, 384
    xa, aa, pw, ms, scale, bias = _w4a8_inputs(g, dev, m, 3072, n, 15360,
                                               120)
    xb, ab = tfg.quant_rows_plain(_rows(g, dev, m, 12288))
    part = t4.w4a8_linear(xa, aa, pw, ms, scale)
    want_part = t4.w4a8_linear_plain(xa, aa, pw, ms, scale)
    assert torch.equal(part, want_part)
    got = t4.w4a8_linear(xb, ab, pw, ms, scale, bias=bias, k0=3072,
                         addend=part)
    _bf16_close(got, t4.w4a8_linear_plain(xb, ab, pw, ms, scale, bias=bias,
                                          k0=3072, addend=want_part))


@pytest.mark.cuda
def test_w4a8_gemm_refuses_what_it_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    xq, a, pw, ms, scale, _ = _w4a8_inputs(g, dev, 8, 512, 64, 512, 4)
    with pytest.raises(ValueError, match="unsupported"):
        t4.w4a8_linear(xq[:, :256], a, pw, ms, scale, k0=192)  # across 256
    with pytest.raises(ValueError, match="unsupported"):
        t4.w4a8_linear(xq, a, pw[:60], ms[:, :60], scale[:60])  # N % 8
    with pytest.raises(ValueError, match="bf16 or f32"):
        t4.w4a8_linear(xq, a, pw, ms, scale, out_dtype=torch.float16)
    with pytest.raises(RuntimeError, match="no backward"):
        t4.w4a8_linear(xq, a, pw, ms, scale.requires_grad_())


@pytest.mark.cuda
@pytest.mark.parametrize("n,inn,groups", [(3072, 3072, 24), (512, 64, 1),
                                          (96, 96, 2), (200, 15360, 120)])
def test_w4_dequant_kernel_bit_for_bit(dev, n, inn, groups):
    """The dequantize kernel equals its plain version bit for bit, at the
    DiT's group of 128, one group, a group of 48 (chunks across groups)
    and the widest input; each launch counted."""
    g = torch.Generator(device=dev).manual_seed(n + inn)
    pw = torch.randint(-128, 128, (n, inn // 2), generator=g, device=dev,
                       dtype=torch.int8)
    scale = torch.rand((groups, n), generator=g, device=dev) / 7
    before = tgemm.GEMM.launches["w4_dequant"]
    got = t4.w4_dequant(pw, scale)
    assert tgemm.GEMM.launches["w4_dequant"] == before + 1
    assert got.dtype == BF and torch.equal(got,
                                           t4.w4_dequant_plain(pw, scale))


# (M, K, N, w4 group size or None for w8): a lone weight tile and the
# partner of an odd tile count, one row and 257 (a second token tile), a
# ring of raw tiles that wraps, groups of 16 (a group a wgmma step)
DEQUANT_GEMM_CASES = [(1, 64, 8, None), (257, 1024, 136, None),
                      (300, 3072, 384, 128), (4, 512, 264, 16),
                      (129, 1536, 256, 64), (64, 15360, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", DEQUANT_GEMM_CASES)
def test_dequant_gemm_against_its_plain_version(dev, m, k, n, group):
    """The dequantizing GEMM: its converted weight (the dump mode) bit for
    bit the dequantize kernel's, its output within two bf16 steps of the
    product's and the output's magnitudes of the plain version's (f32 sums
    in another order, then two roundings: the product's and the bias
    add's); each launch counted."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    if group is None:
        mode = "w8"
        codes = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                              dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) / 100
        weight = tgemm.int8_dequant(codes, scale)
    else:
        mode = "w4"
        codes = torch.randint(-128, 128, (n, k // 2), generator=g,
                              device=dev, dtype=torch.int8)
        scale = torch.rand((k // group, n), generator=g, device=dev) / 7
        weight = t4.w4_dequant(codes, scale)
    x = _randn(g, dev, m, k)
    bias = _randn(g, dev, n) * 0.1
    assert torch.equal(t4.dequant_gemm_weight(x, codes, scale, mode),
                       weight)
    before = tgemm.GEMM.launches["dequant_gemm"]
    got = t4.dequant_linear(x, codes, scale, bias, mode)
    assert tgemm.GEMM.launches["dequant_gemm"] == before + 1
    want = t4.dequant_linear_plain(x, codes, scale, bias, mode)
    prod = t4.dequant_linear_plain(x, codes, scale, None, mode)
    diff = (got.float() - want.float()).abs()
    bar = (2.0 ** -7 * (want.float().abs() + prod.float().abs())
           + 2.0 ** -12 * prod.float().abs().max())
    assert got.dtype == BF and got.shape == (m, n)
    assert bool((diff <= bar).all())


@pytest.mark.cuda
def test_dequant_gemm_refusals(dev):
    """What the kernel does not take raises before a launch: K off a
    multiple of 64, w4 groups of 8, f16 input (f32 input takes the f32
    dequantize kernel and F.linear)."""
    q = torch.zeros((64, 96), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        t4.dequant_linear(torch.zeros((4, 96), dtype=BF, device=dev), q,
                          torch.ones(64, device=dev))
    p4 = torch.zeros((64, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        t4.dequant_linear(torch.zeros((4, 128), dtype=BF, device=dev), p4,
                          torch.ones((16, 64), device=dev), mode="w4")
    with pytest.raises(ValueError, match="bfloat16"):
        t4.dequant_linear(torch.zeros((4, 128), dtype=torch.float16,
                                      device=dev),
                          torch.zeros((64, 128), dtype=torch.int8,
                                      device=dev), torch.ones(64, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,inn,groups", [(3072, 3072, 24), (12288, 3072, 24),
                                          (3072, 12288, 96), (3072, 64, 2),
                                          (96, 96, 8), (200, 15360, 120)])
def test_grad_dequant_kernels_bit_for_bit(dev, n, inn, groups):
    """The straight-through backward's dequantize kernels equal their
    plain versions bit for bit: int8 codes and w4a8 (half-split codes, a
    multiplier per group: the DiT's group of 128, x_embedder's 32, a group
    of 12 whose 8-input chunks cross groups); each launch counted."""
    g = torch.Generator(device=dev).manual_seed(n + inn)
    q = torch.randint(-127, 128, (n, inn), generator=g, device=dev,
                      dtype=torch.int8)
    scale = torch.rand(n, generator=g, device=dev) / 100
    before = tgemm.GEMM.launches["int8_dequant"]
    got = tgemm.int8_dequant(q, scale)
    assert tgemm.GEMM.launches["int8_dequant"] == before + 1
    assert got.dtype == BF and torch.equal(
        got, tgemm.int8_dequant_plain(q, scale))
    pw = torch.randint(-128, 128, (n, inn // 2), generator=g, device=dev,
                       dtype=torch.int8)
    m = torch.randint(1, 16, (groups, n), generator=g, device=dev,
                      dtype=torch.int8)
    before = tgemm.GEMM.launches["w4a8_dequant"]
    got = t4.w4a8_dequant(pw, m, scale)
    assert tgemm.GEMM.launches["w4a8_dequant"] == before + 1
    assert got.dtype == BF and torch.equal(
        got, t4.w4a8_dequant_plain(pw, m, scale))


@pytest.mark.cuda
def test_grad_dequant_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((8, 36), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="unsupported"):
        tgemm.int8_dequant(q, torch.ones(8, device=dev))
    with pytest.raises(ValueError, match="bf16 or f32"):
        tgemm.int8_dequant(q[:, :32], torch.ones(8, device=dev),
                           torch.float16)
    pw = torch.zeros((8, 48), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="groups"):
        t4.w4a8_dequant(pw, torch.ones((5, 8), dtype=torch.int8,
                                       device=dev), torch.ones(8, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["w8a8", "w8", "w4", "w4a8"])
def test_straight_through_dx_on_the_card(dev, mode):
    """A bf16 QuantLinear's dx through the kernels (the product kernel,
    and K8 in w8a8 and w4a8, forward; the dequantize kernel backward),
    each launched once, against the same layer on
    the CPU: the same bf16 weight and dy, f32 sums in another order, so
    within one bf16 step of the largest value."""
    import copy

    from x2i_torch.ops.quant import QuantLinear
    g = torch.Generator(device=dev).manual_seed(3)
    lin = torch.nn.Linear(512, 256, dtype=BF, device=dev)
    layer = QuantLinear.from_linear(lin, mode)
    cpu_layer = copy.deepcopy(layer).cpu()
    x = _randn(g, dev, 2, 40, 512)
    dy = _randn(g, dev, 2, 40, 256)
    # the forward's product kernel and the backward's dequantize kernel,
    # once each
    keys = {"w8a8": ("int8_gemm", "int8_dequant"),
            "w8": ("dequant_gemm", "int8_dequant"),
            "w4": ("dequant_gemm", "w4_dequant"),
            "w4a8": ("w4a8_gemm", "w4a8_dequant")}[mode]
    before = [tgemm.GEMM.launches[k] for k in keys]
    xg = x.clone().requires_grad_()
    layer(xg).backward(dy)
    assert [tgemm.GEMM.launches[k] for k in keys] == [b + 1 for b in before]
    xc = x.cpu().requires_grad_()
    cpu_layer(xc).backward(dy.cpu())
    got, want = xg.grad.float().cpu(), xc.grad.float()
    assert (got - want).abs().max() <= 2.0 ** -7 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_int4_quantizers_on_the_card_match_the_cpu(dev, mode):
    """The int4 quantizers give the same codes, multipliers and scales on
    the card as on the CPU (IEEE divisions by tensors, round half to
    even)."""
    from x2i_torch.ops import quant as tq
    fn = tq.quantize_kernel_w4 if mode == "w4" else tq.quantize_kernel_w4a8
    g = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn((3072, 640), generator=g, device=dev) / 3072 ** 0.5
    for got, want in zip(fn(w), fn(w.cpu())):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_stream_copy_batches_on_the_card_equal_their_numpy_batches(dev):
    """``StreamCopy`` through ``PrefetchLoader``: each batch copied on the
    side stream and taken by a consumer whose stream is busy (a sleep
    kernel queued ahead, then work that reads the batch at once) is bit
    for bit its numpy batch; the copies are pinned and asynchronous."""
    import numpy as np

    from x2i_torch.data.loader import PrefetchLoader, StreamCopy

    rng = np.random.default_rng(0)
    batches = [{"ids": rng.integers(0, 1 << 20, (4, 4096), dtype=np.int32),
                "mask": rng.random((4, 4096)) < 0.5,
                "x": rng.standard_normal((4, 8192)).astype(np.float32)}
               for _ in range(12)]
    copy = StreamCopy(dev)
    for got, want in zip(PrefetchLoader(batches, device_put=copy),
                         batches):
        torch.cuda._sleep(1 << 20)
        # read at once on the consumer's stream: exact for the integers
        sums = {k: got[k].long().sum() for k in ("ids", "mask")}
        for k in want:
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k].cpu(), torch.from_numpy(want[k]))
        for k, total in sums.items():
            assert total.item() == int(want[k].astype(np.int64).sum())


def _rows32(g, dev, *shape, mean=3.0):
    """f32 rows x * sigma + mu, sigma per row over four decades."""
    lead = (*shape[:-1], 1)
    sigma = 10.0 ** (4 * torch.rand(lead, generator=g, device=dev) - 2)
    mu = mean * sigma * torch.randn(lead, generator=g, device=dev)
    return torch.randn(shape, generator=g, device=dev) * sigma + mu


# K6, K7 and K8 on f32 rows: case -> x's shape. They take f32_rows_kernel
# at every width: 16 threads a row at D = 64, a block a row from 1024 on,
# 4 or 16 chunks a thread in registers, past 16384 the rest read again
# from memory.
F32_GLUE_CASES = {
    "4608 rows": (1, 4608, 3072),
    "B 2, odd S, spans cross the batch": (2, 2305, 3072),
    "1 row": (1, 1, 3072),
    "(N, D) 4 rows": (4, 3072),
    "D 64, 16 threads a row": (3, 1001, 64),
    "D 768, a block a row": (1, 257, 768),
    "D 4096": (1, 700, 4096),
    "D 12288": (1, 300, 12288),
    "D 16384": (2, 130, 16384),
    "D 16388, chunks read again": (2, 5, 16388),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["rows", "tie rows"])
@pytest.mark.parametrize("case", list(F32_GLUE_CASES))
def test_f32_quant_rows_kernel_is_exact(dev, case, ties):
    """K8 on f32 rows bit for bit the plain quantization, codes and
    scales, on rows whose scale spans four decades and on tie rows (every
    quotient k + 0.5), one launch of ``quant_rows_f32`` a call; at
    D = 3072 also on 32 and on 256 threads a row, the same bits."""
    shape = F32_GLUE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(sum(shape) + ties)
    if ties:
        x = _tie_rows(g, dev, math.prod(shape[:-1]), shape[-1]).float()
        x = x.view(shape)
    else:
        x = _rows32(g, dev, *shape)
    before = dict(tfg.LAUNCHES)
    q, a = tfg.quant_rows(x)
    assert tfg.LAUNCHES == dict(
        before, quant_rows_f32=before["quant_rows_f32"] + 1)
    q_plain, a_plain = tfg.quant_rows_plain(x)
    assert q.shape == x.shape and a.shape == (*x.shape[:-1], 1)
    assert torch.equal(q, q_plain) and torch.equal(a, a_plain)
    if shape[-1] == 3072:
        for lanes in (32, 256):
            q, a = tfg._quant_rows_cuda(x, instance=(lanes, 16))
            assert torch.equal(q, q_plain) and torch.equal(a, a_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(F32_GLUE_CASES))
def test_f32_gelu_quant_kernel(dev, case):
    """K7 on f32 rows against its f32 plain version: codes within one
    step, at most 0.1% flipped, scales within 1e-5 relative (its
    x / (1 + exp(-2u)) form against PyTorch's tanh form); one launch of
    ``gelu_quant_f32``."""
    shape = F32_GLUE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = _rows32(g, dev, *shape, mean=0.0)
    before = dict(tfg.LAUNCHES)
    got = tfg.gelu_quant(x)
    assert tfg.LAUNCHES == dict(
        before, gelu_quant_f32=before["gelu_quant_f32"] + 1)
    want = tfg.gelu_quant_plain(x)
    _codes_close(got, want, 1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in F32_GLUE_CASES
                                  if len(F32_GLUE_CASES[c]) == 3])
def test_f32_ln_mod_quant_kernel(dev, case):
    """K6 on f32 rows against its f32 plain version (codes within one
    step, at most 0.1% flipped, scales within 1e-5 relative: the row
    statistics are f32 sums in another order), on strided chunk(6)
    modulation rows; at every width bit for bit ``quant_rows(ln_mod(x,
    shift, scale))`` on the card (K5's group and order of sums are K6's:
    one LayerNorm + modulate in both); one launch each."""
    b, s, d = F32_GLUE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(b + s + d)
    x = _rows32(g, dev, b, s, d)
    mod = 0.5 * torch.randn((b, 6 * d), generator=g, device=dev)
    shift, scale = mod[:, :d], mod[:, d:2 * d]
    before = dict(tfg.LAUNCHES)
    got = tfg.ln_mod_quant(x, shift, scale)
    assert tfg.LAUNCHES == dict(
        before, ln_mod_quant_f32=before["ln_mod_quant_f32"] + 1)
    want = tfg.ln_mod_quant_plain(x, shift, scale)
    _codes_close(got, want, 1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    q, a = tfg.quant_rows(tfg.ln_mod(x, shift, scale))
    assert torch.equal(got[0], q) and torch.equal(got[1], a)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["int8", "w4a8"])
@pytest.mark.parametrize("m,k,n,chunked", [
    (300, 3072, 640, False), (4, 3072, 1152, False), (1, 256, 3072, False),
    (129, 64, 64, False), (200, 3072, 384, True)])
def test_f32_gemm_epilogue_is_exact(dev, kernel, m, k, n, chunked):
    """The f32 epilogue of the int8 and the w4a8 GEMM bit for bit its plain
    version (each step rounded once in f32 in its order; the int32 sums
    are exact), with and without the f32 bias, and as the single block's
    two chunks (K-slices of one weight, the second adding the first's f32
    part and the bias); one launch of ``int8_gemm_f32`` /
    ``w4a8_gemm_f32`` a call. f16 is refused."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    width = k + (4096 if chunked else 0)
    if kernel == "int8":
        xq, a, w, scale, bias = _gemm_inputs(g, dev, m, k, n, width)
        extra, fn, plain = (), tgemm.int8_linear, tgemm.int8_linear_plain
    else:
        groups = width // 32
        xq, a, w, ms, scale, bias = _w4a8_inputs(g, dev, m, k, n, width,
                                                 groups)
        extra, fn, plain = (ms,), t4.w4a8_linear, t4.w4a8_linear_plain
    bias = bias.float()
    f32 = torch.float32
    key = f"{kernel}_gemm_f32"
    before = tgemm.GEMM.launches[key]
    for b in (None, bias):
        got = fn(xq, a, w, *extra, scale, bias=b, out_dtype=f32)
        assert got.dtype == f32
        assert torch.equal(got, plain(xq, a, w, *extra, scale, bias=b,
                                      out_dtype=f32))
    assert tgemm.GEMM.launches[key] == before + 2
    if chunked:
        xb, ab = tfg.quant_rows_plain(_rows(g, dev, m, 4096))
        first = fn(xq, a, w, *extra, scale, out_dtype=f32)
        got = fn(xb, ab, w, *extra, scale, bias=bias, k0=k, addend=first,
                 out_dtype=f32)
        want = plain(xb, ab, w, *extra, scale, bias=bias, k0=k,
                     addend=first, out_dtype=f32)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fn(xq, a, w, *extra, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="bias must be"):
        fn(xq, a, w, *extra, scale, bias=bias.to(BF), out_dtype=f32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,inn,groups", [(3072, 3072, 24), (12288, 3072, 24),
                                          (3072, 12288, 96), (3072, 64, 1),
                                          (96, 96, 8), (200, 15360, 120)])
def test_f32_dequant_kernels_bit_for_bit(dev, n, inn, groups):
    """The f32 instances of the int8 and the w4 dequantize kernels equal
    ``dequant_weight_plain(..., torch.float32)`` bit for bit (f32(code)
    times the f32 scale, rounded once), one launch each; and the weight-only
    product on f32 x (the f32 dequantize kernel, then ``F.linear`` in f32
    and the f32 bias) equals the plain version's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n + inn)
    f32 = torch.float32
    q = torch.randint(-127, 128, (n, inn), generator=g, device=dev,
                      dtype=torch.int8)
    s8 = torch.rand(n, generator=g, device=dev) / 100
    pw = torch.randint(-128, 128, (n, inn // 2), generator=g, device=dev,
                       dtype=torch.int8)
    s4 = torch.rand((groups, n), generator=g, device=dev) / 7
    x = torch.randn((5, inn), generator=g, device=dev)
    bias = torch.randn(n, generator=g, device=dev)
    for key, fn, codes, scale, mode in (
            ("int8_dequant_f32", tgemm.int8_dequant, q, s8, "w8"),
            ("w4_dequant_f32", t4.w4_dequant, pw, s4, "w4")):
        before = dict(tgemm.GEMM.launches)
        got = fn(codes, scale, f32)
        assert tgemm.GEMM.launches == dict(before, **{key: before[key] + 1})
        assert got.dtype == f32 and torch.equal(
            got, t4.dequant_weight_plain(codes, scale, mode, f32))
        y = t4.dequant_linear(x, codes, scale, bias, mode)
        assert y.dtype == f32 and torch.equal(
            y, t4.dequant_linear_plain(x, codes, scale, bias, mode))
        with pytest.raises(ValueError, match="bias must be"):
            t4.dequant_linear(x, codes, scale, bias.to(BF), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["w8a8", "w4a8", "w8", "w4"])
def test_f32_quantized_dit_takes_the_kernels(dev, mode):
    """A tiny f32 FLUX in each quantized mode with ``fused_glue=True`` on
    the card: every product and glue call launches an f32 instance (K6,
    K7 and K8 with the GEMM's f32 epilogue in w8a8 and w4a8; K5 with the
    f32 dequantize kernel in w8 and w4), and no bf16 instance; its output
    against the same weights on the plain route on the card within the
    route checks' bar (correlation above 0.999, relative L2 below
    5e-2)."""
    import dataclasses

    cfg = tiny_flux_config(quantized=mode, fused_glue=True,
                           dtype=torch.float32, attention_head_dim=128,
                           num_attention_heads=2, axes_dims_rope=(16, 56, 56),
                           joint_attention_dim=256,
                           pooled_projection_dim=256, time_embed_dim=256,
                           attention_impl="kernel")
    g = torch.Generator(device=dev).manual_seed(7)
    kern = random_init_(FluxTransformer2D(cfg, dev), g)
    plain = FluxTransformer2D(dataclasses.replace(
        cfg, fused_glue=False, quant_impl="plain", attention_impl="plain"),
        dev)
    plain.load_state_dict(kern.state_dict())
    s_img, s_txt = 256, 128
    args = (torch.randn((1, s_img, cfg.in_channels), generator=g, device=dev),
            torch.randn((1, s_txt, cfg.joint_attention_dim), generator=g,
                        device=dev),
            torch.randn((1, cfg.pooled_projection_dim), generator=g,
                        device=dev),
            torch.full((1,), 0.7, device=dev),
            prepare_latent_image_ids(32, 32, dev),
            torch.zeros((s_txt, 3), device=dev))
    before = {**tfg.LAUNCHES, **tgemm.GEMM.launches}
    with torch.inference_mode():
        got = kern(*args)
        used = {k: v - before[k] for k, v in
                {**tfg.LAUNCHES, **tgemm.GEMM.launches}.items()
                if v != before[k]}
        want = plain(*args)
    assert got.dtype == torch.float32
    f32_names = ({"ln_mod_quant_f32", "gelu_quant_f32", "quant_rows_f32",
                  f"{'int8' if mode == 'w8a8' else 'w4a8'}_gemm_f32"}
                 if mode in ("w8a8", "w4a8") else
                 {"ln_mod_f32", f"{'int8' if mode == 'w8' else 'w4'}"
                                f"_dequant_f32"})
    assert set(used) == f32_names, used
    rel = ((got - want).norm() / want.norm()).item()
    corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()])
                          )[0, 1].item()
    assert corr > 0.999 and rel < 5e-2, (corr, rel)
