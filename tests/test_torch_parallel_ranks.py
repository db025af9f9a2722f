"""The parallel layer's process form: one group of 4 ranks, started once
for the module by ``mp.spawn``, runs every process-form check in turn,
each rank against the one-process form computed in the same process; each
test below reads one check's results. The group is gloo on the CPU, and,
in the tests marked ``cuda``, NCCL over four cards, one a rank (skipped
with fewer than four):

* ``shard_batch``, ``replicate_tree`` and ``fsdp_shard_tree`` on a (2, 2,
  1) mesh (JAX's placements of tests/test_runner.py);
* the ring over the 4 ranks equal bit for bit to the one-process ring of
  4 members, output and gradients;
* the tiny FLUX's pipeline forward over 4 ranks (4 stages) equal bit for
  bit to the one-process pipeline, and its gradients (``loss.backward()``
  on every rank: each rank's block parameters, the embedders and the
  head) within 1e-5 relative of the one-process pipeline's;
* ``TrainLoop`` over a (data 2, tensor 2) mesh: two tiny distillation
  steps against the one-process batch-4 loop's parameters, within f32
  reduction order (the gradients averaged over 2 ranks); and with a
  checkpoint directory that every rank shares, a new loop on every rank
  resuming from the main process's last step;
* ``with_mesh`` serving over data 4 against the one-process ``generate``,
  at JAX's bar (max 8 levels, mean below 1); and of a w4 DiT whose AWQ
  pre-scale only rank 0 holds: every rank multiplies by it after;
* the pools over processes (1 infer + 3 train): the first step's loss
  equal to the colocated step's at rtol 1e-4, then two steps from
  ``train_stream``;
* the tiny FLUX under ``shard_activations``, ``shard_sequence`` and both
  over the 4 ranks' tensor axis equal bit for bit to the one-process
  form's forward, each rank holding ``shard_state``'s shard, refusing
  autograd; and ``with_mesh`` serving a (data 1, tensor 4) mesh under
  both flags equal bit for bit to the one-process form's images;
* the tiny FLUX in w8a8 and w4a8 (quantized at group 16) under both flags,
  and in f32 with LightControl's controls under both flags, over the 4
  ranks equal bit for bit to the one-process form, each rank holding only
  ``shard_state``'s shard (w4a8's codes packed again over its inputs).

The store is a file under the test's temporary directory (no fixed port:
several workers run at once), every group has a 60 s timeout and the
spawn joins with a limit, so that a stuck rank fails the test instead of
hanging the suite. Imports no JAX. On a machine with four cards:
``python -m pytest --noconftest tests/test_torch_parallel_ranks.py``.
"""

import datetime
import itertools
import json
import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_LIMIT_S = 240.0


# ---------------------------------------------------------------- checks
# each runs on every rank and returns a JSON-able dict of what it saw

def check_placements(rank, dev, root):
    from torch.distributed.tensor import Replicate, Shard

    from x2i_torch.core.config import MeshConfig
    from x2i_torch.core.mesh import (data_index, fsdp_shard_tree, make_mesh,
                                     replicate_tree, shard_batch)
    mesh = make_mesh(MeshConfig(data=2, fsdp=2, tensor=1),
                     device_type=dev.type)
    batch = {"x": torch.arange(24.0).reshape(8, 3),
             "odd": torch.arange(6.0).reshape(3, 2), "s": torch.tensor(2.0)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    got = shard_batch(batch, mesh)
    index, count = data_index(mesh)
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(16, 64, generator=g),
            "b": torch.randn(64, generator=g), "tiny": torch.randn(3, 5,
                                                                generator=g)}
    tree = {k: v.to(dev) for k, v in tree.items()}
    sharded = fsdp_shard_tree(tree, mesh, min_size=64)
    replicated = replicate_tree(tree, mesh)
    return {
        "coordinate": mesh.get_coordinate(), "index": index, "count": count,
        "x_share": torch.equal(got["x"], batch["x"][2 * rank:2 * rank + 2]),
        "odd_whole": torch.equal(got["odd"], batch["odd"]),
        "scalar_whole": torch.equal(got["s"], batch["s"]),
        "w": [list(sharded["w"].placements) == [Replicate(), Shard(1),
                                                 Replicate()],
              list(sharded["w"].to_local().shape),
              torch.equal(sharded["w"].full_tensor(), tree["w"])],
        "b": [list(sharded["b"].placements) == [Replicate(), Shard(0),
                                                 Replicate()],
              list(sharded["b"].to_local().shape)],
        "tiny_replicated": all(isinstance(p, Replicate)
                               for p in sharded["tiny"].placements),
        "replicated": all(all(isinstance(p, Replicate) for p in v.placements)
                          and torch.equal(v.to_local(), tree[k])
                          for k, v in replicated.items()),
    }


def check_ring(rank, dev, root):
    from x2i_torch.ops.ring_attention import ring_attention
    from x2i_torch.parallel.axis import GroupAxis, LocalAxis
    g = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(2, 4 * 64, 3, 32, generator=g).to(dev)
                  for _ in range(4))

    def run(axis):
        qs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ring_attention(*qs, axis)
        return (out.detach(), *torch.autograd.grad((out * w).sum(), qs))

    got = run(GroupAxis(dist.group.WORLD, "tensor"))
    want = run(LocalAxis(WORLD, "tensor"))
    return {"equal": [torch.equal(a, b) for a, b in zip(got, want)]}


def _tiny_flux(dev):
    from x2i_torch.core.config import tiny_flux_config
    from x2i_torch.diffusion.sampling import prepare_latent_image_ids
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.params import random_init_
    cfg = tiny_flux_config()
    model = random_init_(FluxTransformer2D(cfg),
                         torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    b = 3
    args = (torch.randn(b, 16, cfg.in_channels, generator=g),
            torch.randn(b, 8, cfg.joint_attention_dim, generator=g),
            torch.randn(b, cfg.pooled_projection_dim, generator=g),
            torch.full((b,), 0.5), prepare_latent_image_ids(8, 8, "cpu"),
            torch.zeros(8, 3))
    return model.to(dev), tuple(a.to(dev) for a in args)


def check_pipeline(rank, dev, root):
    from x2i_torch.models.flux import flux_pipeline_forward
    from x2i_torch.parallel.axis import GroupAxis, LocalAxis

    def run(axis):
        model, args = _tiny_flux(dev)
        out = flux_pipeline_forward(model, *args, axis=axis)
        (out.square().sum()).backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters()}

    got, got_g = run(GroupAxis(dist.group.WORLD, "stage"))
    want, want_g = run(LocalAxis(WORLD, "stage"))
    # this rank's chunks: double block `rank` of 4 (2 blocks padded to 4),
    # single block `rank` of 4
    mine = {f"double_blocks.{rank}.", f"single_blocks.{rank}."}
    rel, missing, stray = 0.0, [], []
    for name, gw in want_g.items():
        in_stack = name.startswith(("double_blocks.", "single_blocks."))
        expect = not in_stack or any(name.startswith(m) for m in mine)
        gg = got_g[name]
        if expect and gw is not None:
            if gg is None:
                missing.append(name)
                continue
            rel = max(rel, ((gg - gw).abs().max()
                            / gw.abs().max().clamp_min(1e-30)).item())
        elif gg is not None and gg.abs().max() > 0:
            stray.append(name)
    return {"forward_equal": torch.equal(got, want), "grad_rel": rel,
            "missing": missing, "stray": stray}


def _proj_after(mesh, dev, steps=2):
    from x2i_torch.train.harness import build_tiny_distill
    from x2i_torch.train.runner import TrainLoop
    step, state, batch, _ = build_tiny_distill(batch_size=4, device=dev)
    metrics = []
    TrainLoop(step, state, itertools.repeat(batch), seed=3, mesh=mesh,
              log_every=1, on_metrics=lambda i, m: metrics.append(
                  [float(m["loss"]), float(m["grad_norm"])])).run(steps)
    return [p.detach().clone() for p in state.proj.parameters()], metrics


def check_train_loop(rank, dev, root):
    from x2i_torch.core.config import MeshConfig
    from x2i_torch.core.mesh import make_mesh
    mesh = make_mesh(MeshConfig(data=2, fsdp=1, tensor=2),
                     device_type=dev.type)
    got, got_metrics = _proj_after(mesh, dev)
    want, want_metrics = _proj_after(None, dev)
    diffs = [(a - b).abs() for a, b in zip(got, want)]
    return {"max_abs": max(d.max().item() for d in diffs),
            "above_1e-6": sum(int((d > 1e-6).sum()) for d in diffs),
            "params": sum(d.numel() for d in diffs),
            "metrics": got_metrics, "want_metrics": want_metrics}


def check_checkpoints(rank, dev, root):
    from x2i_torch.core.config import MeshConfig
    from x2i_torch.core.mesh import make_mesh
    from x2i_torch.train.harness import build_tiny_distill
    from x2i_torch.train.runner import TrainLoop
    mesh = make_mesh(MeshConfig(data=2, fsdp=1, tensor=2),
                     device_type=dev.type)
    ckpt = os.path.join(root, "ckpt")          # one directory, every rank

    def loop():
        step, state, batch, _ = build_tiny_distill(batch_size=4, device=dev)
        return TrainLoop(step, state, itertools.repeat(batch), seed=3,
                         mesh=mesh, checkpoint_dir=ckpt,
                         checkpointing_steps=1)

    first = loop()
    first.run(2)
    resumed = loop()
    return {"resumed_at": resumed.state.step,
            "steps_on_disk": sorted(d for d in os.listdir(ckpt)
                                    if d.isdigit()),
            "equal": all(torch.equal(a, b) for a, b in zip(
                first.state.proj.parameters(),
                resumed.state.proj.parameters()))}


def check_serving(rank, dev, root):
    from x2i_torch.core.config import MeshConfig
    from x2i_torch.core.mesh import make_mesh
    from x2i_torch.pipeline import build_random_pipeline
    pipe = build_random_pipeline("tiny", seed=0, device=dev)
    mesh = make_mesh(MeshConfig(data=-1), device_type=dev.type)
    mpipe = pipe.with_mesh(mesh)
    rng = np.random.default_rng(0)
    cfg = pipe.flux.cfg
    embeds = torch.as_tensor(rng.standard_normal(
        (WORLD, 16, cfg.joint_attention_dim)), dtype=torch.float32,
        device=dev)
    pooled = torch.as_tensor(rng.standard_normal(
        (WORLD, cfg.pooled_projection_dim)), dtype=torch.float32,
        device=dev)
    want = pipe.generate(pooled, embeds, seed=5)
    got = mpipe.generate(pooled, embeds, seed=5)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    try:
        mpipe.generate(pooled[:3], embeds[:3], seed=5)
        raised = False
    except ValueError:
        raised = True
    return {"shape": list(got.shape), "max": int(d.max()),
            "mean": float(d.mean()), "raised": raised}


def check_awq_serving(rank, dev, root):
    """A w4 DiT whose first layer holds an AWQ pre-scale on rank 0 only
    (the other ranks built theirs with ones): after ``with_mesh`` every
    rank holds rank 0's pre-scale, knows it is not ones, and multiplies
    by it; the layers of ones still skip."""
    from x2i_torch.core.config import MeshConfig
    from x2i_torch.core.mesh import make_mesh
    from x2i_torch.ops.int4_gemm import dequant_linear_plain
    from x2i_torch.ops.quant import QuantLinear, quantize_module_
    from x2i_torch.pipeline import build_random_pipeline
    pipe = build_random_pipeline("tiny", seed=0, device=dev)
    quantize_module_(pipe.flux, "w4")
    layers = [m for m in pipe.flux.modules() if isinstance(m, QuantLinear)]
    awq = layers[0]
    want_scale = torch.linspace(0.5, 2.0, awq.in_features)
    if rank == 0:
        with torch.no_grad():
            awq.pre_scale.copy_(want_scale)
        awq.note_pre_scale_()
    pipe.with_mesh(make_mesh(MeshConfig(data=-1), device_type=dev.type))
    x = torch.randn((3, awq.in_features),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    want = dequant_linear_plain((x * want_scale.to(dev)).to(awq.dtype),
                                awq.pweight, awq.scale, awq.bias, "w4")
    with torch.no_grad():
        got = awq(x)
    return {"pre_scale": torch.equal(awq.pre_scale.cpu(), want_scale),
            "awq_flag": awq.pre_scale_ones,
            "others_skip": all(m.pre_scale_ones for m in layers[1:]),
            "awq_product": torch.equal(got, want)}


def check_pools(rank, dev, root):
    from x2i_torch.parallel.disaggregated import DisaggregatedDistill
    from x2i_torch.train.harness import build_tiny_distill
    step_fn, state, batch, _ = build_tiny_distill(batch_size=3, device=dev)
    _, colocated = step_fn(state, batch, 7)
    (teacher_fn, student_fn), state2, batch, parts = build_tiny_distill(
        batch_size=3, split=True, device=dev)
    dd = DisaggregatedDistill(teacher_fn, student_fn, None, None, state2,
                              n_infer_devices=1)
    out = {"is_infer": dd.is_infer, "colocated": float(colocated["loss"])}
    tout = dd.teacher_step(batch, 7)
    if not dd.is_infer:
        out["loss"] = float(dd.step(dd.train_batch(batch), tout, 7)["loss"])
    stream_losses = []
    for i, (tb, to) in enumerate(dd.train_stream(itertools.repeat(batch, 2),
                                                 itertools.count(8))):
        stream_losses.append(float(dd.step(tb, to, 8 + i)["loss"]))
    out["stream_losses"] = stream_losses
    return out


TP_FLAGS = {"tp": dict(shard_activations=True),
            "sp": dict(shard_sequence=True),
            "tp+sp": dict(shard_activations=True, shard_sequence=True)}


def check_tensor_parallel(rank, dev, root):
    from x2i_torch.core.config import MeshConfig
    from x2i_torch.core.mesh import make_mesh
    from x2i_torch.parallel.axis import GroupAxis, LocalAxis
    from x2i_torch.parallel.tensor import shard_state
    from x2i_torch.pipeline import build_random_pipeline
    out = {}
    for label, flags in TP_FLAGS.items():
        model, args = _tiny_flux(dev)
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        model.replace_config(**flags)
        local, _ = _tiny_flux(dev)
        local.replace_config(**flags).set_tensor_axis(LocalAxis(WORLD))
        model.set_tensor_axis(GroupAxis(dist.group.WORLD, "tensor"))
        with torch.no_grad():
            equal = torch.equal(model(*args), local(*args))
        state = model.state_dict()
        mine = shard_state(whole, model.cfg, rank, WORLD) \
            if flags.get("shard_activations") else whole
        try:
            model(*args)
            refused = False
        except RuntimeError:
            refused = True
        out[label] = {"equal": equal, "refused_grad": refused,
                      "shard": all(torch.equal(state[k], mine[k])
                                   for k in mine)}
    pipes = [build_random_pipeline("tiny", seed=0, device=dev)
             for _ in range(2)]
    for pipe in pipes:
        pipe.flux.replace_config(**TP_FLAGS["tp+sp"])
    served = pipes[0].with_mesh(make_mesh(MeshConfig(data=1, tensor=WORLD),
                                          device_type=dev.type))
    pipes[1].flux.set_tensor_axis(LocalAxis(WORLD))
    rng = np.random.default_rng(0)
    cfg = pipes[1].flux.cfg
    embeds = torch.as_tensor(rng.standard_normal(
        (2, 16, cfg.joint_attention_dim)), dtype=torch.float32, device=dev)
    pooled = torch.as_tensor(rng.standard_normal(
        (2, cfg.pooled_projection_dim)), dtype=torch.float32, device=dev)
    got = served.generate(pooled, embeds, seed=5)
    out["with_mesh_equal"] = bool(np.array_equal(
        got, pipes[1].generate(pooled, embeds, seed=5)))
    out["with_mesh_shard"] = list(served.flux.tensor_shard)
    return out


def check_tensor_quant(rank, dev, root):
    from x2i_torch.ops.quant import quantize_module_
    from x2i_torch.parallel.axis import GroupAxis, LocalAxis
    from x2i_torch.parallel.tensor import shard_state
    out = {}
    g = torch.Generator().manual_seed(7)
    for label in ("w8a8", "w4a8", "controls"):
        model, args = _tiny_flux(dev)
        local, _ = _tiny_flux(dev)
        kw = {}
        if label == "controls":
            cfg = model.cfg
            kw["controls"] = (torch.randn(cfg.num_layers, args[0].shape[0],
                                          args[0].shape[1], cfg.inner_dim,
                                          generator=g) * 0.5).to(dev)
        else:
            # f32: the plain quantization and products (also over NCCL,
            # where the kernels take bf16 only)
            for m in (model, local):
                quantize_module_(m.replace_config(quant_impl="plain"),
                                 label, group=16)
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        for m in (model, local):
            m.replace_config(**TP_FLAGS["tp+sp"])
        local.set_tensor_axis(LocalAxis(WORLD))
        model.set_tensor_axis(GroupAxis(dist.group.WORLD, "tensor"))
        with torch.no_grad():
            equal = torch.equal(model(*args, **kw), local(*args, **kw))
        state = model.state_dict()
        mine = shard_state(whole, model.cfg, rank, WORLD)
        out[label] = {"equal": equal,
                      "shard": state.keys() == mine.keys() and all(
                          torch.equal(state[k], mine[k]) for k in mine)}
    return out


CHECKS = {"placements": check_placements, "ring": check_ring,
          "pipeline": check_pipeline, "train_loop": check_train_loop,
          "checkpoints": check_checkpoints, "serving": check_serving,
          "awq_serving": check_awq_serving, "pools": check_pools,
          "tensor_parallel": check_tensor_parallel,
          "tensor_quant": check_tensor_quant}


def _rank_main(rank, backend, init_file, out_dir):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    extra, dev = {}, torch.device("cpu")
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        extra["device_id"] = dev
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank,
                            timeout=GROUP_TIMEOUT, **extra)
    results = {}
    try:
        for name, check in CHECKS.items():
            t0 = time.perf_counter()
            try:
                results[name] = check(rank, dev, out_dir)
            except Exception:  # noqa: BLE001  (reported by the test)
                results[name] = {"error": traceback.format_exc()}
            results[name]["seconds"] = time.perf_counter() - t0
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[
    "gloo", pytest.param("nccl", marks=pytest.mark.cuda)])
def ranks(request, tmp_path_factory):
    """-> [rank 0's results, ..., rank 3's]: one spawn for the module and
    backend; NCCL needs four cards."""
    backend = request.param
    if backend == "nccl" and torch.cuda.device_count() < WORLD:
        pytest.skip(f"NCCL over {WORLD} ranks needs {WORLD} CUDA devices")
    root = tmp_path_factory.mktemp(f"ranks-{backend}")
    ctx = mp.spawn(_rank_main, args=(backend, str(root / "store"),
                                     str(root)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOIN_LIMIT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks did not finish in "
                                   f"{JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in ctx.processes)
    out = []
    for r in range(WORLD):
        with open(root / f"rank{r}.json") as f:
            out.append(json.load(f))
    print(f"ranks[{backend}]:", json.dumps(out))   # shown under -s
    return out


def _each(ranks, name):
    for r, res in enumerate(ranks):
        got = res[name]
        assert "error" not in got, f"rank {r}: {got['error']}"
        yield r, got


def test_placements(ranks):
    for r, got in _each(ranks, "placements"):
        assert got["index"] == r and got["count"] == 4
        assert got["coordinate"] == [r // 2, r % 2, 0]
        assert got["x_share"] and got["odd_whole"] and got["scalar_whole"]
        assert got["w"] == [True, [16, 32], True]
        assert got["b"] == [True, [32]]
        assert got["tiny_replicated"] and got["replicated"]


def test_process_ring_equals_one_process_ring(ranks):
    for _, got in _each(ranks, "ring"):
        assert got["equal"] == [True] * 4


def test_process_pipeline(ranks):
    for _, got in _each(ranks, "pipeline"):
        assert got["forward_equal"]
        assert not got["missing"] and not got["stray"]
        assert got["grad_rel"] <= 1e-5


def test_data_parallel_train_loop(ranks):
    """Within f32 reduction order (the loss's terms and the gradients
    summed over 2 ranks, not over one batch of 4): each step's loss and
    gradient norm within 1e-6 relative, and the parameters after 2 steps
    within 1e-6 but for at most 0.1% of them. Those are elements whose
    gradient is rounding noise (the proj's conv bias: Adam's first moment
    1.6e-10 there, its true gradient 0), which AdamW's normalized update
    moves by some fraction of the learning rate (1e-3; the first step's
    is 0) whatever the noise: measured 1 of 10,476 elements, 2.8e-5 off
    on the CPU's gloo and 5.1e-4 on four H100s over NCCL; bounded by two
    updates' size, 2e-3."""
    for _, got in _each(ranks, "train_loop"):
        np.testing.assert_allclose(got["metrics"], got["want_metrics"],
                                   rtol=1e-6)
        assert got["above_1e-6"] <= got["params"] // 1000, got
        assert got["max_abs"] <= 2e-3, got


def test_data_parallel_checkpoints(ranks):
    """The main process writes each step behind a barrier; every rank
    resumes from the last one, its proj the run's."""
    for _, got in _each(ranks, "checkpoints"):
        assert got["resumed_at"] == 2 and got["equal"], got
        assert got["steps_on_disk"] == ["1", "2"], got


def test_data_parallel_serving(ranks):
    for _, got in _each(ranks, "serving"):
        assert got["shape"] == [WORLD, 64, 64, 3] and got["raised"]
        assert got["max"] <= 8 and got["mean"] < 1.0, got


def test_data_parallel_serving_keeps_rank_0s_awq_pre_scale(ranks):
    for _, got in _each(ranks, "awq_serving"):
        assert got == {"pre_scale": True, "awq_flag": False,
                       "others_skip": True, "awq_product": True,
                       "seconds": got["seconds"]}, got


def test_process_pools(ranks):
    for r, got in _each(ranks, "pools"):
        assert got["is_infer"] == (r == 0)
        if r:
            np.testing.assert_allclose(got["loss"], got["colocated"],
                                       rtol=1e-4)
            assert len(got["stream_losses"]) == 2
            assert np.isfinite(got["stream_losses"]).all()
        else:
            assert got["stream_losses"] == []


def test_process_tensor_parallel_equals_one_process(ranks):
    for r, got in _each(ranks, "tensor_parallel"):
        for label in TP_FLAGS:
            assert got[label] == {"equal": True, "refused_grad": True,
                                  "shard": True}, (label, got[label])
        assert got["with_mesh_equal"] and got["with_mesh_shard"] == [r, 4]


@pytest.mark.parametrize("label", ["w8a8", "w4a8", "controls"])
def test_process_tensor_parallel_quantized_and_controlled(ranks, label):
    """w8a8 and w4a8 under both flags (int32 sums by ``all_reduce`` /
    ``reduce_scatter``, the row absmax by ``all_reduce(MAX)``) and a
    controlled forward: bit for bit the one-process form, each rank
    holding only its shard."""
    for r, got in _each(ranks, "tensor_quant"):
        assert got[label] == {"equal": True, "shard": True}, (r, got)
