"""The sharded DiT's process form over NCCL on four cards, at full width:
x2i-internvl2.5-1b drawn on every card from the seed (as
``chip_smoke.build_pipeline`` draws it), a (data 1, fsdp 1, tensor 4)
mesh, and ``X2IPipeline.with_mesh`` serving one 4-step image a case:

* ``tp-image``, ``sp-image``, ``tp+sp-image``: 1024^2 under
  ``shard_activations``, ``shard_sequence`` and both;
* ``tp-2048``: 2048^2 under ``shard_activations``;
* ``tp+sp-control``: 1024^2 under both flags with LightControl's
  19-branch bank (``chip_smoke.draw_bank``, replicated on every rank) on a
  guidance image (``chip_smoke.control_image``);
* ``tp-w8a8``: 1024^2 under ``shard_activations``, the DiT drawn again
  and quantized in place to w8a8 (the row-split layers' row absmax by
  ``all_reduce(MAX)``, their int32 sums by ``all_reduce``).

Rank 0 first makes each bf16 case's image in the one-process form on its
own card (``LocalAxis(4, "tensor")`` over the whole DiT, the other ranks
waiting), then every rank serves the cases in the process form
(``sp-image`` first, on the whole DiT; then each rank cuts its shard in
place for the others); then every rank draws the DiT again in w8a8, rank
0 makes ``tp-w8a8``'s one-process image, and every rank serves it. Each
case: one warm-up image (none at 2048^2, as in ``chip_smoke.py``), one
timed image (host clock from a barrier to the image on the host), then
one image under ``torch.profiler``: its kernels' device time, the NCCL
kernels' share of it, and the profiled wall time. Rank 0's image is held
against its one-process image (bit for bit, and the relative L2 and level
differences).

    python3 x2i_torch/tools/tensor_nccl.py [--seed N] [--out PATH]

Run from the root of the repo on a machine with four CUDA cards and nvcc.
Prints one JSON object a case (rank 0's, with every rank's seconds) and
the cards' names and power limits; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
WORLD = 4
CASES = (("sp-image", dict(shard_sequence=True), 1024),
         ("tp-image", dict(shard_activations=True), 1024),
         ("tp+sp-image", dict(shard_activations=True, shard_sequence=True),
          1024),
         ("tp-2048", dict(shard_activations=True), 2048),
         ("tp+sp-control", dict(shard_activations=True,
                                shard_sequence=True), 1024))
# served after the bf16 cases, on the DiT drawn again and quantized
QUANT_CASES = (("tp-w8a8", dict(shard_activations=True), 1024),)
JOIN_LIMIT_S = 1500.0


def _flags(flux, flags):
    flux.replace_config(shard_activations=bool(flags.get(
        "shard_activations")), shard_sequence=bool(flags.get(
            "shard_sequence")))


def _request(seed, px, control=None) -> dict:
    import chip_smoke as cs
    req = dict(task="text2image", prompt=cs.PROMPTS[0], seed=seed,
               height=px, width=px, num_steps=4)
    if control is not None:
        req["control_pixels"] = control
    return req


def _image(pipe, seed, px, warm, barrier, control=None):
    """-> (the image, its seconds): one warm-up first with ``warm``; the
    clock starts after a barrier of every rank with ``barrier``;
    ``control`` a guidance image for a pipeline with controls."""
    import torch
    import torch.distributed as dist

    req = _request(seed, px, control)
    if warm:
        pipe.run_task(**req)
    torch.cuda.synchronize()
    if barrier:
        dist.barrier()
    t0 = time.perf_counter()
    img = pipe.run_task(**req)
    return img, time.perf_counter() - t0


def _profiled(pipe, seed, px, control=None) -> dict:
    """One image under ``torch.profiler``: the kernels' device ms, the
    NCCL kernels' ms and count, and the profiled wall ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_task(**_request(seed, px, control))
        wall = time.perf_counter() - t0
    kernels_ms = nccl_ms = 0.0
    nccl_n = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            kernels_ms += ms
            if "nccl" in ev.name.lower():
                nccl_ms += ms
                nccl_n += 1
    return {"profiled_wall_ms": wall * 1e3, "kernels_ms": kernels_ms,
            "nccl_ms": nccl_ms, "nccl_kernels": nccl_n,
            "nccl_share": nccl_ms / kernels_ms if kernels_ms else None}


def _rank_main(rank, init_file, out_dir, seed):
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from x2i_torch.core.config import MeshConfig
    from x2i_torch.core.mesh import make_mesh, mesh_axis
    from x2i_torch.ops.quant import quantize_module_
    from x2i_torch.parallel.axis import LocalAxis

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank, device_id=dev)
    results = {}
    try:
        if rank == 0:
            cs.phase_build()
        dist.barrier()
        _, pipe, dit_state = cs.build_pipeline(seed)
        bank_cfg, bank = cs.draw_bank(seed)
        guidance = cs.control_image(seed)

        def route(base, label):
            # the controlled case's pipeline and guidance image
            if label.endswith("control"):
                return base.with_controls(bank_cfg, bank), guidance
            return base, None

        def serve(cases, served):
            """Rank 0's one-process images of ``cases``, then every rank's
            process-form images; -> the served (mesh) pipeline."""
            flux = pipe.flux
            ref = {}
            if rank == 0:
                for label, flags, px in cases:
                    _flags(flux, flags)
                    flux.set_tensor_axis(LocalAxis(WORLD, "tensor"))
                    on, control = route(pipe, label)
                    ref[label] = _image(on, seed, px, px <= 1024, False,
                                        control)
                    flux.set_tensor_axis(None)
                    _flags(flux, {})
                    torch.cuda.empty_cache()
            dist.barrier()
            for label, flags, px in cases:
                _flags(flux, flags)
                if served is None:
                    served = pipe.with_mesh(mesh)
                else:
                    flux.set_tensor_axis(mesh_axis(mesh, "tensor"))
                on, control = route(served, label)
                torch.cuda.reset_peak_memory_stats()
                img, sec = _image(on, seed, px, px <= 1024, True, control)
                rec = {"case": label, "flags": flags, "px": px,
                       "rank": rank, "s_per_image": sec,
                       "quantized": flux.cfg.quantized,
                       "first_call": None if px <= 1024 else
                       "the route's first image (no warm-up)",
                       "shard": list(flux.tensor_shard or ()),
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated(),
                       **_profiled(on, seed, px, control)}
                if rank == 0:
                    want, one_s = ref[label]
                    a, b = img.astype(np.float32), want.astype(np.float32)
                    rec.update(
                        s_per_image_one_process=one_s,
                        bit_equal_one_process=bool(np.array_equal(img,
                                                                  want)),
                        rel_l2_one_process=float(np.linalg.norm(a - b)
                                                 / np.linalg.norm(b)),
                        max_level_diff=float(np.abs(a - b).max()),
                        image_shape=list(img.shape),
                        image_std=float(a.std()))
                results[label] = rec
            return served

        mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=WORLD))
        serve(CASES, None)
        # the DiT again, whole, quantized in place on every rank
        pipe.flux = None
        gc.collect()
        torch.cuda.empty_cache()
        pipe.flux = quantize_module_(cs.draw_dit(dit_state)[0], "w8a8")
        serve(QUANT_CASES, None)
    except Exception:  # noqa: BLE001  (reported by the parent)
        results["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the cases here (JSON)")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp
    if torch.cuda.device_count() < WORLD:
        print(f"tensor_nccl: needs {WORLD} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_main, args=(os.path.join(tmp, "store"), tmp,
                                         args.seed),
                       nprocs=WORLD, join=False)
        deadline = time.monotonic() + JOIN_LIMIT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {WORLD} ranks did not finish "
                                       f"in {JOIN_LIMIT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    errors = {r: res["error"] for r, res in enumerate(ranks)
              if "error" in res}
    cases = []
    for label, _, _ in CASES + QUANT_CASES:
        if label not in ranks[0]:
            continue
        rec = dict(ranks[0][label])
        rec["ranks_s_per_image"] = [res[label]["s_per_image"]
                                    for res in ranks if label in res]
        rec["ranks_nccl_ms"] = [res[label]["nccl_ms"]
                                for res in ranks if label in res]
        rec["cards"] = smi
        cases.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"cases": cases, "errors": errors, "cards": smi}, f,
                      indent=1)
    for line in smi:
        print(line)
    if errors:
        print(json.dumps({"errors": errors}), flush=True)
        return 1
    ok = all(c.get("rel_l2_one_process", 1.0) <= 2.5e-2 for c in cases)
    return 0 if ok and len(cases) == len(CASES + QUANT_CASES) else 1


if __name__ == "__main__":
    sys.exit(main())
