"""Measure three things about the LM's decode on the card that
``chip_smoke.py``'s ``answer`` phase takes once or not at all:

* a mid-answer step's kernels by ``torch.profiler``: their count and
  their summed device time, beside the ``answer`` phase's ``step_times``
  (host enqueue, and the step replayed from a CUDA graph);
* the spread of the use_answer image's time and of the decode's ms per
  token (the host sets the decode's pace, so both move with the host):
  ``--runs`` of each first, then after ``step_times`` (a graph capture),
  then after the profiler session;
* what the ``answer`` phase's bars (``check_answer``) see when the decode
  is wrong: the same request decoded at answer positions one past the
  right ones, held against the cache-less forward at the right ones.

    python3 x2i_torch/tools/decode_spread.py [--runs N] [--seed N]

Run from the root of the repo on a machine with a CUDA card and nvcc. It
draws the x2i-qwenvl2.5-7b entry (the 28 x 3584 LM, its proj, the
schnell DiT, the VAE) on the card from the seed, as the registry phase
does, and prints one JSON object per measurement, then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def build_entry(seed: int):
    """-> (the pipeline over the 7B entry, its LM), weights drawn on the
    card as ``chip_smoke.phase_registry`` draws them."""
    import torch

    import chip_smoke as cs
    from x2i_torch.convert.load import mllm_encoder
    from x2i_torch.core.config import MODEL_REGISTRY, GenerationConfig
    from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
    from x2i_torch.models.proj import Proj
    from x2i_torch.models.qwen2 import Qwen2LM
    from x2i_torch.models.vae import AutoencoderKL
    from x2i_torch.params import random_init_
    from x2i_torch.pipeline import X2IPipeline

    dev = torch.device("cuda")
    name = cs.ANSWER_MODEL
    spec = MODEL_REGISTRY[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    flux = cs.draw_dit(g.get_state())[0]
    vae = random_init_(AutoencoderKL(spec.vae, dev), g)
    g = torch.Generator(device=dev).manual_seed(
        seed + zlib.crc32(name.encode()))
    lm = random_init_(Qwen2LM(spec.llm, dev), g)
    proj = random_init_(Proj(spec.proj, dev), g)
    enc = mllm_encoder(name, lm, cs.ByteTokenizer("qwenvl"))
    return X2IPipeline(
        encoder_fn=enc, proj=proj, flux=flux, vae=vae,
        scheduler=FlowMatchEulerScheduler(spec.scheduler),
        gen_cfg=GenerationConfig(height=1024, width=1024,
                                 num_inference_steps=4),
        encoder_batch_fn=enc.batch), lm


def profile_step(lm, ids, mask, rope) -> dict:
    """A mid-answer decode step (as ``chip_smoke.step_times`` builds it)
    under ``torch.profiler``: its kernels' count and summed device time,
    medians of 3."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    s0, t = ids.shape[1], cs.ANSWER_TOKENS
    with torch.inference_mode():
        cache = lm.init_cache(1, s0 + t)
        lm.prefill_cached(lm.embed(ids), mask, cache, rope)
        idx = s0 + t // 2
        kv = (torch.arange(s0 + t, device=ids.device)[None] <= idx) & \
            torch.nn.functional.pad(mask, (0, t), value=True)
        pos = torch.full((1, 1), idx, device=ids.device)
        lm.decode_step(lm.embed(ids[:, :1]), cache, idx, kv, pos)
        device, launches = [], []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lm.decode_step(lm.embed(ids[:, :1]), cache, idx, kv, pos)
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            device.append(sum(e.time_range.elapsed_us() for e in kernels)
                          / 1e3)
            launches.append(len(kernels))
    return {"kernels_device_ms": statistics.median(device),
            "launches": statistics.median(launches)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke as cs
    from x2i_torch.models.decoding import greedy_decode_with_hiddens

    if not torch.cuda.is_available():
        print("decode_spread: needs a CUDA device", file=sys.stderr)
        return 2
    cs.phase_build()
    entry, lm = build_entry(args.seed)
    ids, mask, pos3d, rope = cs._answer_request(lm, cs.PROMPTS[0])

    def run():
        t0 = time.perf_counter()
        entry.text2image(cs.PROMPTS[0], seed=args.seed, use_answer=True)
        image_s = time.perf_counter() - t0
        timing, _ = cs.decode_timing(lm, ids, mask, pos3d, rope)
        return [image_s, timing["decode_ms_per_token"]]

    run()                                                   # warm-up
    first = [run() for _ in range(args.runs)]
    times = cs.step_times(lm, ids, mask, rope)
    after_graph = [run() for _ in range(args.runs)]
    profile = profile_step(lm, ids, mask, rope)
    after_profiler = [run() for _ in range(args.runs)]
    print(json.dumps({"measure": "spread (s/image, ms/token)",
                      "first": first, "step_times": times,
                      "after_step_times": after_graph, "profile": profile,
                      "after_profiler": after_profiler}), flush=True)

    with torch.inference_mode():
        wrong = greedy_decode_with_hiddens(
            lm, lm.embed(ids), mask, cs.ANSWER_TOKENS, -1,
            prefill_rope=rope, step_pos0=pos3d.amax(dim=(0, 2)) + 2)[:3]
    rec, ok = cs.check_answer(lm, ids, mask, pos3d, wrong)
    print(json.dumps({"measure": "answer positions one off",
                      "answer_vs_forward": rec["answer_vs_forward"],
                      "answer_block1": rec["answer_rel_mean_by_layer"][1],
                      "bars": rec["bars_rel_max_mean_layer1"],
                      "passes_the_bars": ok}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
