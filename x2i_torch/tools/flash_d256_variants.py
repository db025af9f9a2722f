"""Time K2 (``csrc/flash_chunked.cu``), K3 and K4 (``csrc/flash_bwd.cu``)
at the shapes of their head-dim-256 records and at their records at
D = 64 and 128, and K5 on f32 rows (``csrc/row_glue.cu``) at its records'
shapes, on the repo's libraries and on each variant given, forced for the
call.

    python3 x2i_torch/tools/flash_d256_variants.py [--variant NAME=DIR]...
        [--case LABEL]... [--repeat N] [--out FILE]

Run from the root of the repo on a machine with a CUDA card and nvcc. A
variant is a directory that holds a ``flash_chunked.cu``, a
``flash_bwd.cu`` and / or a ``row_glue.cu`` beside the headers they
include (the ``x2i_torch/csrc`` of another checkout, say the parent
commit's from ``git archive``); its libraries are built like the repo's
(``cuda_lib.CudaLibrary``) and take the wrapper's place
(``flash_attention.KERNEL_CHUNKED`` / ``KERNEL_BWD``,
``fused_glue.ROW_GLUE``) for the call. A variant without a source of a
kernel runs the repo's. A K5 case may force the wrapper's instance, (threads a row,
chunks a thread) (``fused_glue.f32_instance``); a variant's library is
called with the same arguments, so a parent's library that takes other
ones is not a variant of K5.

Per case, each library's outputs against the plain version
(``max_abs_err``, and relative to the largest |plain| value of each
output) and whether they are bit for bit the repo's (``same_as_repo``),
or the error of a library that refuses the call (the parent's K4 at
D = 256 with rope asks for partial sums the wrapper no longer makes); its device time
(``kernel_ms`` of ``chip_smoke.py``), taken in turns, the repo's library
first and last (repo, variants..., variants reversed, repo), so that each
library's two readings bracket the others (``--repeat`` N: N such
rounds). Prints one JSON object: per
library the build's faults (``cuda_lib.build_faults`` on the library's
gated kernels) and the registers of every K2, K3, K4 and K5 instance;
per case
and library ``ms`` (the readings), ``max_abs_err``,
``rel_max_err`` and ``same_as_repo``; the card's name and power limit as
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
# label -> (kernel, batch, q heads, kv heads, Sq, Skv, D, dtype, what):
# K2 "plain" / "lse" (with the lse) / "lm" (kv mask of 30,000 keys and
# causal) / "odd" (per-batch masks 1100 and 37 and causal); K3 and K4
# "plain" (rope outside), "rope" (inside), "pad" (4112 of 4224 keys, rope
# inside), "lm" (the LM prefill's 40 keys, causal). K5: (kernel, batch,
# rows, width, instance or None)
CASES = {
    "K2 (1,12,16896,256)": ("k2", 1, 12, 12, 16896, 16896, 256, "bf16",
                            "plain"),
    "K2-lse (1,12,8448,256)": ("k2", 1, 12, 12, 8448, 8448, 256, "bf16",
                               "lse"),
    "K2-lse f32 (1,12,8448,256)": ("k2", 1, 12, 12, 8448, 8448, 256, "f32",
                                   "lse"),
    "K2 (1,24,16896,128)": ("k2", 1, 24, 24, 16896, 16896, 128, "bf16",
                            "plain"),
    "K2 LM 32k (1,14,32768,64) on 2": ("k2", 1, 14, 2, 32768, 32768, 64,
                                       "bf16", "lm"),
    "K2 LM 32k 7B (1,28,32768,128) on 4": ("k2", 1, 28, 4, 32768, 32768, 128,
                                           "bf16", "lm"),
    "K2 odd (2,6,640,128) on (2,2,1152,128)": ("k2", 2, 6, 2, 640, 1152, 128,
                                               "bf16", "odd"),
    "K3 (1,12,4608,256)": ("k3", 1, 12, 12, 4608, 4608, 256, "bf16",
                           "plain"),
    "K3 rope (1,12,4608,256)": ("k3", 1, 12, 12, 4608, 4608, 256, "bf16",
                                "rope"),
    "K3 pad (1,12,4224,256), 4112 keys": ("k3", 1, 12, 12, 4224, 4224, 256,
                                          "bf16", "pad"),
    "K3 shard (1,12,1152,256)": ("k3", 1, 12, 12, 1152, 1152, 256, "bf16",
                                 "plain"),
    "K3 f32 (1,12,4608,256)": ("k3", 1, 12, 12, 4608, 4608, 256, "f32",
                               "plain"),
    "K3 (1,24,4608,128)": ("k3", 1, 24, 24, 4608, 4608, 128, "bf16",
                           "plain"),
    "K3 LM (1,14,512,64) on 2, 40 keys": ("k3", 1, 14, 2, 512, 512, 64,
                                          "bf16", "lm"),
    "K4 (1,12,4608,256)": ("k4", 1, 12, 12, 4608, 4608, 256, "bf16",
                           "plain"),
    "K4 rope (1,12,4608,256)": ("k4", 1, 12, 12, 4608, 4608, 256, "bf16",
                                "rope"),
    "K4 pad (1,12,4224,256), 4112 keys": ("k4", 1, 12, 12, 4224, 4224, 256,
                                          "bf16", "pad"),
    "K4 shard (1,12,1152,256)": ("k4", 1, 12, 12, 1152, 1152, 256, "bf16",
                                 "plain"),
    "K4 f32 (1,12,4608,256)": ("k4", 1, 12, 12, 4608, 4608, 256, "f32",
                               "plain"),
    "K4 (1,24,4608,128)": ("k4", 1, 24, 24, 4608, 4608, 128, "bf16",
                           "plain"),
    "K4 LM (1,14,512,64) on 2, 40 keys": ("k4", 1, 14, 2, 512, 512, 64,
                                          "bf16", "lm"),
    "K5 f32 (1,4608,3072)": ("k5", 1, 4608, 3072, None),
    "K5 f32 (1,4096,3072)": ("k5", 1, 4096, 3072, None),
    "K5 f32 (1,512,3072)": ("k5", 1, 512, 3072, None),
    "K5 f32 (1,4608,4096)": ("k5", 1, 4608, 4096, None),
    "K5 f32 (1,4608,6144)": ("k5", 1, 4608, 6144, None),
}
# kernel -> (source, module of its wrapper, its library there)
SOURCES = {"k2": ("flash_chunked.cu", "flash_attention", "KERNEL_CHUNKED"),
           "k3": ("flash_bwd.cu", "flash_attention", "KERNEL_BWD"),
           "k4": ("flash_bwd.cu", "flash_attention", "KERNEL_BWD"),
           "k5": ("row_glue.cu", "fused_glue", "ROW_GLUE")}


def make_case(case, dev, g):
    """-> (fn, inputs, want): the call, its inputs ((B, H, S, D) views of
    (B, S, H, D) tensors, as the dispatcher passes them) and the plain
    version's output."""
    import torch

    import chip_smoke
    from x2i_torch.ops import flash_attention as fa
    from x2i_torch.ops import fused_glue as fg

    if case[0] == "k5":
        _, b, rows, width, instance = case
        x = torch.randn((b, rows, width), generator=g, device=dev)
        x = x * 10.0 ** torch.empty((b, rows, 1), device=dev).uniform_(
            -2.0, 2.0, generator=g)
        shift, scale = (0.5 * torch.randn((b, width), generator=g,
                                          device=dev) for _ in range(2))
        fn = functools.partial(fg._launch_f32, "ln_mod", instance=instance)
        return fn, (x, shift, scale), fg.ln_mod_plain(x, shift, scale)
    kernel, b, hq, hk, sq, skv, d, dtype, what = case
    dt = torch.float32 if dtype == "f32" else torch.bfloat16

    def randn(s, h):
        return torch.randn((b, s, h, d), generator=g, device=dev,
                           dtype=dt).transpose(1, 2)

    q, k, v = randn(sq, hq), randn(skv, hk), randn(skv, hk)
    kw = {}
    if what == "lm":
        kw = dict(kv_mask=(torch.arange(skv, device=dev)[None]
                           < (30000 if kernel == "k2" else 40)), causal=True)
    elif what == "odd":
        kw = dict(kv_mask=torch.arange(skv, device=dev)[None] < torch.tensor(
            [[1100], [37]], device=dev), causal=True)
    elif what == "pad":
        kw["kv_mask"] = torch.arange(skv, device=dev)[None] < 4112
    if kernel == "k2":
        lse = what == "lse"
        fn = functools.partial(fa.flash_forward_chunked, return_lse=lse,
                               **kw)
        want = fa.flash_forward_chunked_plain(q, k, v, block_q=4096,
                                              block_k=4096, return_lse=lse,
                                              **kw)
        return fn, (q, k, v), want
    if what in ("rope", "pad"):
        px = 1024 if what == "rope" else 960
        s = 512 + (px // 16) ** 2
        cos, sin = chip_smoke._rope_tables(512, px // 8, (32, 112, 112), dev)
        kw["rope"] = tuple(torch.nn.functional.pad(t, (0, 0, 0, sq - s))
                           for t in (cos, sin))
    do = randn(sq, hq)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    res = (do, lse, fa._delta(o, do))
    fn, plain = ((fa.flash_bwd_dq, fa.flash_bwd_dq_plain) if kernel == "k3"
                 else (fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain))
    return (functools.partial(fn, **kw), (q, k, v, *res),
            plain(q, k, v, *res, **kw))


def outputs(x):
    return x if isinstance(x, tuple) else (x,)


def library_report(lib, names):
    """The build's faults and the registers of the kernels in ``names``."""
    from x2i_torch.ops import cuda_lib
    lib.lib()
    report = cuda_lib.ptxas_report(lib.build_log)
    return {"build_faults": cuda_lib.build_faults(lib.build_log,
                                                  lib.gated_kernels),
            "registers": {k: r["registers"] for k, r in report.items()
                          if any(n in k for n in names)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR", help="a variant's csrc directory")
    ap.add_argument("--case", action="append", default=[],
                    metavar="LABEL", help="a case of CASES (all)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="rounds of timing in turns")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import importlib

    import chip_smoke
    from x2i_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        print("flash_d256_variants: needs a CUDA device", file=sys.stderr)
        return 2
    labels = args.case or list(CASES)
    modules = {k: importlib.import_module(f"x2i_torch.ops.{module}")
               for k, (_, module, _) in SOURCES.items()}
    # per kernel: [(library name, CudaLibrary)], the repo's first; K3 and
    # K4 share a library
    libs = {k: [("repo", getattr(modules[k], attr))]
            for k, (_, _, attr) in SOURCES.items()}
    built = {}
    for spec in args.variant:
        name, _, directory = spec.partition("=")
        for kernel, (source, _, attr) in SOURCES.items():
            path = Path(directory).resolve() / source
            if not path.exists():
                continue
            repo = getattr(modules[kernel], attr)
            if (name, source) not in built:
                built[name, source] = cuda_lib.CudaLibrary(
                    str(path), f"libx2i_variant_{name}_{path.stem}",
                    tuple(repo.launches), repo._bind,
                    wgmma_kernels=repo.wgmma_kernels,
                    checked_kernels=repo.gated_kernels[
                        len(repo.wgmma_kernels):])
            libs[kernel].append((name, built[name, source]))
    names = ("flash_chunked_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv",
             "ln_mod_f32")
    result = {"libraries": {
        f"{SOURCES[kernel][0]} {name}": library_report(lib, names)
        for kernel, pairs in libs.items() for name, lib in pairs}}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for label in labels:
        kernel = CASES[label][0]
        module, attr = modules[kernel], SOURCES[kernel][2]
        repo_lib = getattr(module, attr)
        fn, inputs, want = make_case(CASES[label], dev, g)
        want = [w.float() for w in outputs(want)]
        tops = [w.abs().max().item() for w in want]
        row = result.setdefault(label, {})
        outs, ran = {}, []
        for name, lib in libs[kernel]:
            setattr(module, attr, lib)
            try:
                got = outputs(fn(*inputs))
                torch.cuda.synchronize()
            except RuntimeError as err:
                # a library that refuses the wrapper's arguments
                row[name] = {"error": str(err)}
                continue
            ran.append((name, lib))
            outs[name] = got
            errs = [(a.float() - w).abs().max().item()
                    for a, w in zip(got, want)]
            row[name] = {"ms": [], "max_abs_err": max(errs),
                         "rel_max_err": max(e / t for e, t
                                            in zip(errs, tops)),
                         "same_as_repo": all(torch.equal(a, b) for a, b
                                             in zip(got, outs["repo"]))}
        del outs
        order = (ran + ran[::-1]) * args.repeat
        for name, lib in order:
            setattr(module, attr, lib)
            row[name]["ms"].append(chip_smoke.kernel_ms(fn, *inputs))
        setattr(module, attr, repo_lib)
        print(json.dumps({label: row}), file=sys.stderr, flush=True)
        del fn, inputs, want
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
