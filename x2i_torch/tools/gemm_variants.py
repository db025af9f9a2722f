"""Time the w4a8 GEMM against cut-down copies of itself, to see where its
time goes, beside the int8 GEMM on the same operand.

    python3 x2i_torch/tools/gemm_variants.py [--out FILE]

Run from the root of the repo on a machine with a CUDA card and nvcc.
Builds ``x2i_torch/csrc/int8_gemm.cu`` as it is and two copies with a
piece of the w4a8 conversion taken out, all at once into the ignored
``x2i_torch/_build/variants/``; loads each in turn into the wrapper
(``ops/int4_gemm.py``) and times the w4a8 GEMM (device time, the
``kernel_ms`` of ``chip_smoke.py``) at four shapes of the w4a8 DiT, then
the int8 GEMM on the materialized operand code x m. The copies compute
wrong sums (each record says whether the sum is exact); they only time:

* ``conversion emptied``: the packed tiles go to the tensor cores as they
  landed (the ring, the pairing of K steps, the barriers and the epilogue
  alone);
* ``no arithmetic``: the conversion loads and stores its chunks but takes
  the nibbles as they are, without the multipliers (so it loads none).

Prints one JSON object: per shape, per variant, [ms, sum exact], and the
int8 GEMM's ms; and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
VARIANTS = {
    "as is": [],
    "conversion emptied": [
        ("    for (int c = 0; c < kStepBytes / 16; ++c) {\n"
         "      const int col = conv_p + 16 * c;",
         "    for (int c = 0; c < 0; ++c) {\n"
         "      const int col = conv_p + 16 * c;")],
    "no arithmetic": [
        ("  return ((x | 0x80808080u) - m8) ^ (~x & 0x80808080u);",
         "  return nib;")],
}
# (label, M, K, N, inputs, k0): the w4a8 DiT's products at 1024^2
SHAPES = (("single mlp_in", 4608, 3072, 12288, 3072, 0),
          ("single out, attn chunk (low half)", 4608, 3072, 3072, 15360, 0),
          ("single out, mlp chunk (across the half)", 4608, 12288, 3072,
           15360, 3072),
          ("double adaLN mods, 4 steps", 4, 3072, 18432, 3072, 0))


def build(name: str, src: str, out: Path) -> Path:
    from x2i_torch.ops import cuda_lib
    from x2i_torch.ops.int8_gemm import GEMM
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    stem = name.replace(" ", "_")
    cu, so = out / f"{stem}.cu", out / f"{stem}.so"
    cu.write_text(src)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *cuda_lib.NVCC_FLAGS, "-I",
                           str(cuda_lib.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    faults = cuda_lib.build_faults(proc.stdout + proc.stderr,
                                   GEMM.gated_kernels)
    if faults:
        raise RuntimeError(f"{name}: {faults}")
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from x2i_torch.ops import cuda_lib, fused_glue, int4_gemm, int8_gemm
    from x2i_torch.ops.quant import quantize_kernel_w4a8

    if not torch.cuda.is_available():
        print("gemm_variants: needs a CUDA device", file=sys.stderr)
        return 2
    out = cuda_lib.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (cuda_lib.CSRC / "int8_gemm.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda name: build(name, src, out), VARIANTS)))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, m, k, n, inn, k0 in SHAPES:
        w = torch.randn((n, inn), generator=g, device=dev) / inn ** 0.5
        pk, ms, scale = quantize_kernel_w4a8(w.t())
        x = (torch.randn((m, k), generator=g, device=dev) * 3).to(
            torch.bfloat16)
        xq, a = fused_glue.quant_rows_plain(x)
        cases.append((label, k0, xq, a, pk.t().contiguous(), ms, scale))

    result = {}
    gemm = int8_gemm.GEMM
    saved = gemm.lib()
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        int8_gemm._bind(lib)
        gemm._lib = lib
        for label, k0, xq, a, pw, ms, scale in cases:
            exact = torch.equal(
                int4_gemm.w4a8_matmul_acc(xq, pw, ms, k0),
                int4_gemm.w4a8_matmul_acc_plain(xq, pw, ms, k0))
            ms_ = chip_smoke.kernel_ms(
                lambda x, s, w, ms=ms, scale=scale, k0=k0:
                int4_gemm.w4a8_linear(x, s, w, ms, scale, None, k0),
                xq, a, pw)
            result.setdefault(label, {})[name] = [ms_, exact]
    gemm._lib = saved
    for label, k0, xq, a, pw, ms, scale in cases:
        codes = int4_gemm.w4a8_codes(pw, ms)[:, k0:k0 + xq.shape[1]]
        result[label]["int8 GEMM on code x m"] = chip_smoke.kernel_ms(
            lambda x, s, w, scale=scale: int8_gemm.int8_linear(x, s, w,
                                                               scale),
            xq, a, codes.contiguous())
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
