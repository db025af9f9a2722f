"""Time the w4 and w8 images on the dequantizing GEMM against the route the
w4 mode took before it: the dequantize kernel (``w4_dequant`` or
``int8_dequant``) writing each layer's bf16 weight, then cuBLAS
(``F.linear``) and the bias. Both routes skip w4's identity pre-scale, so
the two differ only in the dense products.

    python3 x2i_torch/tools/quant_route_ab.py [--out FILE]

Run from the root of the repo on a machine with a CUDA card and nvcc.
Builds the kernels and the full-width bf16 text path as ``chip_smoke.py``
does (its build and text2image phases), then for w4 and w8 quantizes the
DiT drawn again from the same generator state and takes the 1024^2 image
of ``chip_smoke.run_image`` four times, in the order GEMM, dequantize +
cuBLAS, dequantize + cuBLAS, GEMM, each with its launch counts held exact.
The second route is this tool's own: it replaces ``QuantLinear``'s product
function while it runs and puts it back after. Prints one JSON object: per
mode and route, each run's s/image and DiT step ms, the relative L2
distance between the two routes' pixels, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ORDER = ("dequantizing GEMM", "dequantize + cuBLAS", "dequantize + cuBLAS",
         "dequantizing GEMM")


def dequantize_then_cublas(x, codes, scale, bias=None, mode="w8",
                           impl="auto"):
    """The product as the w4 mode computed it before the dequantizing GEMM:
    the dequantize kernel's bf16 weight, ``F.linear``, then the bias in
    the layer's dtype."""
    import torch.nn.functional as F

    from x2i_torch.ops.int4_gemm import w4_dequant
    from x2i_torch.ops.int8_gemm import int8_dequant
    dequant = w4_dequant if mode == "w4" else int8_dequant
    y = F.linear(x, dequant(codes, scale, x.dtype, impl))
    return y if bias is None else y + bias.to(y.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import gc

    import torch

    if not torch.cuda.is_available():
        print("quant_route_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from x2i_torch.ops import quant
    from x2i_torch.ops.quant import quantize_module_

    cs.phase_build()
    pipe, _, _, _, dit_state = cs.phase_text2image(args.seed)
    kernel_route = quant.dequant_linear
    result = {}
    for mode in ("w4", "w8"):
        pipe.flux = None
        gc.collect()
        torch.cuda.empty_cache()
        pipe.flux = quantize_module_(cs.draw_dit(dit_state)[0], mode)
        gemm_want = cs.expected_launches(mode, 4)
        old_want = dict(gemm_want, dequant_gemm=0)
        old_want["w4_dequant" if mode == "w4" else "int8_dequant"] = \
            gemm_want["dequant_gemm"]
        runs, pixels = {}, {}
        try:
            for route in ORDER:
                old = route == "dequantize + cuBLAS"
                quant.dequant_linear = (dequantize_then_cublas if old
                                        else kernel_route)
                rec, px, counts = cs.run_image(
                    pipe, args.seed, f"{mode}, {route}",
                    old_want if old else gemm_want)
                if counts != rec["launches_expected"]:
                    raise AssertionError(f"{mode}, {route}: launches "
                                         f"{counts} != "
                                         f"{rec['launches_expected']}")
                runs.setdefault(route, []).append(
                    [rec["s_per_image"], rec["dit_step_ms"]])
                pixels[route] = px.float()
        finally:
            quant.dequant_linear = kernel_route
        a, b = pixels.values()
        result[mode] = {"s_per_image, dit_step_ms": runs,
                        "pixels_rel_l2_between_routes":
                        ((a - b).norm() / b.norm()).item()}
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
