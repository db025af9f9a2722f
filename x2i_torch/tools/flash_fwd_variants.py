"""Time K1 (``csrc/flash_fwd.cu``) at the shapes of its main paths, on the
grid instance the wrapper's rule picks and, with ``--instances``, on every
other instance of the head dim, forced for the call.

    python3 x2i_torch/tools/flash_fwd_variants.py [--cases x,y]
        [--instances] [--out FILE]

Run from the root of the repo on a machine with a CUDA card and nvcc.
Builds the library (``flash_attention.KERNEL``), then, per case, holds the
kernel against its plain version (``max_abs_err``) and times it (device
time, the ``kernel_ms`` of ``chip_smoke.py``); an instance is forced by
replacing the wrapper's ``fwd_instance`` for the call.

Prints one JSON object: the build's faults (``cuda_lib.build_faults``) and
the registers of every K1 instance, the blocks an SM each instance holds
on the card, and per case the instance the rule picks and, per instance
timed, [ms, max_abs_err]; the card's name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# label -> (batch, q heads, kv heads, S, D, valid keys or None, what):
# "mask" the pad route's kv mask (non-causal), "causal" the LM's mask and
# causal, "rope" K1a with per-row qk scales, "lse" K1 with the lse,
# "rope-mask" the masked body with the rope (the pad route of a DiT)
CASES = {
    "ViT (1,16,1152,64), 1025 keys": (1, 16, 16, 1152, 64, 1025, "mask"),
    "(1,16,1024,64), 897 keys": (1, 16, 16, 1024, 64, 897, "mask"),
    "(1,16,768,64), 641 keys": (1, 16, 16, 768, 64, 641, "mask"),
    "(1,16,512,64), 385 keys": (1, 16, 16, 512, 64, 385, "mask"),
    "(1,16,256,64), 129 keys": (1, 16, 16, 256, 64, 129, "mask"),
    "CLIP (4,16,384,64), 257 keys": (4, 16, 16, 384, 64, 257, "mask"),
    "LM (1,14,512,64) on 2, 40 keys": (1, 14, 2, 512, 64, 40, "causal"),
    "LM (1,16,512,128) on 2, 400 keys": (1, 16, 2, 512, 128, 400, "causal"),
    "LM (1,28,512,128) on 4, 400 keys": (1, 28, 4, 512, 128, 400, "causal"),
    "K1a (1,24,4608,128)": (1, 24, 24, 4608, 128, None, "rope"),
    "K1a (1,12,4608,256)": (1, 12, 12, 4608, 256, None, "rope"),
    "K1-lse (1,12,4608,256)": (1, 12, 12, 4608, 256, None, "lse"),
    "K1-lse (1,12,1152,256)": (1, 12, 12, 1152, 256, None, "lse"),
    "pad route (1,12,4224,256), 4112 keys":
        (1, 12, 12, 4224, 256, 4112, "rope-mask"),
}


def make_case(case, dev, g):
    """-> (fn, q, k, v, plain): the call and its plain version on (B, H,
    S, D) views of (B, S, H, D) tensors, as the dispatcher passes them."""
    import torch
    from x2i_torch.ops import flash_attention as fa

    b, hq, hk, s, d, valid, what = case
    bf = torch.bfloat16
    q = torch.randn((b, s, hq, d), generator=g, device=dev, dtype=bf)
    k, v = (torch.randn((b, s, hk, d), generator=g, device=dev, dtype=bf)
            for _ in range(2))
    kw = {}
    if valid is not None:
        kw["kv_mask"] = (torch.arange(s, device=dev)[None] < valid).expand(
            b, s).contiguous()
    if what == "causal":
        kw["causal"] = True
    if what.startswith("rope"):
        import chip_smoke
        axes = {128: (16, 56, 56), 256: (32, 112, 112)}[d]
        cos, sin = chip_smoke._rope_tables(512, 128, axes, dev)
        kw["rope"] = (cos[:s].contiguous(), sin[:s].contiguous())
        w = [1.0 + 0.1 * torch.randn((s, d), generator=g, device=dev)
             for _ in range(2)]
        kw["qk_norm"] = (*w, 1e-6)
    if what == "lse":
        fn = functools.partial(fa.flash_forward_lse, **kw)
        plain = functools.partial(fa.flash_attention_plain,
                                  return_lse=True, **kw)
    else:
        fn = functools.partial(fa.flash_attention, **kw)
        plain = functools.partial(fa.flash_attention_plain, **kw)
    return fn, *(t.transpose(1, 2) for t in (q, k, v)), plain


def first(x):
    return x[0] if isinstance(x, tuple) else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", help="comma-separated labels (all)")
    ap.add_argument("--instances", action="store_true",
                    help="also time each case on every instance of its D")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from x2i_torch.ops import cuda_lib
    from x2i_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_fwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    labels = args.cases.split(",") if args.cases else list(CASES)
    fa.KERNEL.lib()
    log = fa.KERNEL.build_log
    result = {
        "build_faults": cuda_lib.build_faults(log, fa.KERNEL.gated_kernels),
        "registers": {k: r["registers"]
                      for k, r in cuda_lib.ptxas_report(log).items()
                      if "flash_fwd_kernel" in k},
        "blocks_per_sm": {str(list(i)): fa.fwd_blocks_per_sm(*i)
                          for i in fa.FWD_INSTANCES}}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = fa.fwd_instance
    g = torch.Generator(device=dev).manual_seed(0)
    for label in labels:
        fn, q, k, v, plain = make_case(CASES[label], dev, g)
        b, hq, _, s, d, _, _ = CASES[label]
        picked = rule(b, hq, s, d, sms)
        forced = [picked] + ([i[1:] for i in fa.FWD_INSTANCES
                              if i[0] == d and i[1:] != picked]
                             if args.instances else [])
        want = first(plain(q, k, v))
        row = result.setdefault(label, {"rule": list(picked)})
        for inst in forced:
            fa.fwd_instance = (lambda *a, i=inst: i)
            got = first(fn(q, k, v))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            row[str(list(inst))] = [chip_smoke.kernel_ms(fn, q, k, v), err]
        fa.fwd_instance = rule
        del q, k, v, want
        torch.cuda.empty_cache()
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
