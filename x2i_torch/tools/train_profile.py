"""Measure three things about the training steps on the card that
``chip_smoke.py``'s ``distill`` and ``train-resume`` phases take once or
not at all:

* the phase-1 step in three configurations on the same DiT and LM: bf16
  at ``DistillConfig``'s defaults (the ``distill`` phase's), bf16 at JAX's
  single-chip point (inline KD, int8 teacher stacks, 8-bit AdamW), and
  w8a8 at that point (the ``train-resume`` phase's): teacher and student
  s per step, peak memory;
* one w8a8 step at that point under ``torch.profiler``: its kernels'
  device time summed by name (the events of ``DeviceType.CUDA``), their
  total against the step's wall time under the profiler (the card's busy
  share; the profiler's own host cost lowers it), and the launch count;
* the phase-2 optimizer's update on the 19-branch bank alone, 32-bit
  ``AdamW`` and ``AdamW8bit`` in turns, on the same gradients.

    python3 x2i_torch/tools/train_profile.py [--seed N] [--steps N]
        [--updates N]

Run from the root of the repo on a machine with a CUDA card and nvcc. It
draws x2i-internvl2.5-1b on the card from the seed as ``chip_smoke.py``
does (T5-XXL and CLIP-L for the teacher), and prints one JSON object per
measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _steps(pipe, lm, dcfg, seed: int, steps: int, profile: bool):
    """``steps`` steps (the first a warm-up) of the split phase-1 step on
    the pipeline's DiT and LM; with ``profile`` one more under
    ``torch.profiler``. -> the record."""
    import torch
    from x2i_torch.train.harness import build_random_distill
    from x2i_torch.train.runner import step_noise

    (teacher_fn, student_fn), state, batch, parts = build_random_distill(
        "full", seed, flux=pipe.flux, lm=lm, dcfg=dcfg)
    times = []
    for i in range(steps):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = teacher_fn(batch, step_noise(seed, i))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = student_fn(state, batch, out, step_noise(seed, i))
        float(metrics["loss"])
        times.append((t1 - t0, time.perf_counter() - t1))
        del out
    rec = {"teacher_s": statistics.mean(t for t, _ in times[1:]),
           "student_s": statistics.mean(s for _, s in times[1:]),
           "steps_s": [t + s for t, s in times[1:]],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = teacher_fn(batch, step_noise(seed, steps))
            state, metrics = student_fn(state, batch, out,
                                        step_noise(seed, steps))
            float(metrics["loss"])
            wall = time.perf_counter() - t0
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
                by_name[ev.name][1] += 1
        busy = sum(ms for ms, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda item: -item[1][0])[:25]
        rec.update(profile_wall_ms=wall * 1e3, kernels_ms=busy,
                   busy_share=busy / (wall * 1e3),
                   launches=sum(n for _, n in by_name.values()),
                   top=[(name[:100], round(ms, 2), n)
                        for name, (ms, n) in top])
    del state, batch, parts, teacher_fn, student_fn
    pipe.flux.replace_config(remat=False, rope_in_kernel=True,
                             fused_glue=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def optimizer_updates(seed: int, updates: int):
    """The 32-bit and the 8-bit update of the 19-branch bank (bf16,
    ``ControlNeXtConfig()``) on the same gradients, in turns: -> their
    median seconds an update (the card synchronized around each)."""
    import torch
    from x2i_torch.core.config import ControlNeXtConfig
    from x2i_torch.models.controlnext import ControlBank
    from x2i_torch.params import random_init_
    from x2i_torch.train.optim import AdamW
    from x2i_torch.train.optim8bit import AdamW8bit

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bank = random_init_(ControlBank(ControlNeXtConfig(), 19, dev), g)
    params = list(bank.parameters())
    grads = [(torch.randn(p.shape, generator=g, device=dev) * 1e-3)
             .to(p.dtype) for p in params]
    opts = {"adamw": AdamW(1e-5, 1.0), "adamw8bit": AdamW8bit(1e-5, 1.0)}
    states = {k: o.init(params) for k, o in opts.items()}
    times = {k: [] for k in opts}
    for _ in range(updates + 1):                   # the first: a warm-up
        for k, opt in opts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[k] = opt.update(params, grads, states[k])
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: {"median_s": statistics.median(v[1:]), "min_s": min(v[1:]),
                "max_s": max(v[1:])} for k, v in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--updates", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from x2i_torch.core.config import DistillConfig
    from x2i_torch.ops.quant import quantize_module_

    cs.phase_build()
    lm, pipe, _ = cs.build_pipeline(args.seed)
    point = DistillConfig(inline_kd=True, kd_stacks_int8=True,
                          use_8bit_adam=True, lr_warmup_steps=1)
    for label, dcfg, quantize in (
            ("bf16 DistillConfig defaults",
             DistillConfig(lr_warmup_steps=1), False),
            ("bf16 single-chip point", point, False),
            ("w8a8 single-chip point", point, True)):
        if quantize:
            quantize_module_(pipe.flux, "w8a8")
        rec = _steps(pipe, lm, dcfg, args.seed, args.steps, quantize)
        print(json.dumps({"measure": "phase-1 step", "config": label, **rec}),
              flush=True)
    del pipe, lm
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"measure": "phase-2 optimizer update",
                      **optimizer_updates(args.seed, args.updates)}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
