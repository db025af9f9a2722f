"""The device mesh and the data-parallel layout, the counterpart of
``x2i_tpu/core/mesh.py``.

JAX lays one ``jax.sharding.Mesh`` over the devices of one controller and
lets XLA insert the collectives. PyTorch runs one process per device:
``make_mesh`` builds a ``DeviceMesh`` with the three named axes (data,
fsdp, tensor) over the ranks of the process group, starting the group from
``torchrun``'s environment (``core/multihost.py``) where none exists, and
otherwise a group of this one process (the one-member mesh, for which the
caller sets no environment variable, as JAX's runs on one device).

``shard_batch`` gives each rank its dim-0 slice of a batch over (data,
fsdp); ``replicate_tree`` and ``fsdp_shard_tree`` place parameter trees as
DTensors (``Replicate()``, ``Shard(dim)``). ``data_axis`` is the (data,
fsdp) axis over which gradients are averaged, and ``StepShard`` one data
rank's share of a training step.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from x2i_torch.core import multihost
from x2i_torch.core.config import MeshConfig
from x2i_torch.parallel.axis import GroupAxis

# how long a rank of a mesh started here waits for its peers
MESH_TIMEOUT = datetime.timedelta(seconds=600)


def mesh_shape(cfg: MeshConfig, n: int) -> list:
    """JAX's rules for ``n`` devices: an axis of -1 takes what the fixed
    axes leave; raises ValueError when they do not divide ``n`` or the
    sizes do not multiply to it."""
    sizes = [cfg.data, cfg.fsdp, cfg.tensor]
    fixed = math.prod(s for s in sizes if s != -1)
    if n % fixed != 0:
        raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
    sizes = [n // fixed if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    return sizes


def _ensure_group(device_type: str):
    """The process group: the existing one, else one started from the
    environment, else a group of this process alone (an in-memory
    store: no port, no network)."""
    if dist.is_initialized():
        return
    backend = "gloo" if device_type == "cpu" else "nccl"
    if multihost.initialize(backend=backend):
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=MESH_TIMEOUT)


def make_mesh(cfg: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """A (data, fsdp, tensor) ``DeviceMesh`` over the group's ranks, rank r
    at the r-th position in row-major order (data outermost)."""
    from torch.distributed.device_mesh import DeviceMesh

    cfg = cfg or MeshConfig()
    _ensure_group(device_type)
    sizes = mesh_shape(cfg, dist.get_world_size())
    grid = torch.arange(dist.get_world_size()).reshape(sizes)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(cfg.axis_names))


def mesh_axis(mesh, name: str) -> GroupAxis:
    """The process form of one named axis of ``mesh``."""
    return GroupAxis(mesh.get_group(name), name)


def data_axis(mesh) -> GroupAxis:
    """The (data, fsdp) axis: the ranks that share a tensor coordinate,
    data-major. A collective call: every rank of the mesh makes it."""
    if mesh.size(mesh.mesh_dim_names.index("fsdp")) == 1:
        return mesh_axis(mesh, "data")
    if mesh.size(mesh.mesh_dim_names.index("data")) == 1:
        return mesh_axis(mesh, "fsdp")
    mine = None
    grid = mesh.mesh
    for t in range(grid.shape[2]):
        ranks = grid[:, :, t].flatten().tolist()
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = group
    return GroupAxis(mine, "data+fsdp")


def data_index(mesh) -> tuple:
    """-> (this rank's index, count) over (data, fsdp), data-major."""
    names = mesh.mesh_dim_names
    data, fsdp = names.index("data"), names.index("fsdp")
    coord = mesh.get_coordinate()
    return (coord[data] * mesh.size(fsdp) + coord[fsdp],
            mesh.size(data) * mesh.size(fsdp))


def tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples; other
    leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def take_share(x: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Share ``index`` of ``count`` of dim 0; the whole of a 0-d tensor or
    one whose dim 0 does not divide (JAX replicates those)."""
    if x.dim() == 0 or x.shape[0] % count:
        return x
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def shard_batch(batch, mesh):
    """This rank's dim-0 slice of every tensor of ``batch`` over (data,
    fsdp)."""
    index, count = data_index(mesh)
    return tree_map(lambda x: take_share(x, index, count), batch)


def replicate_tree(tree, mesh):
    """Every tensor a DTensor replicated over the mesh (each rank's copy
    its own tensor: no transfer)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    place = [Replicate()] * mesh.ndim
    return tree_map(lambda x: distribute_tensor(x, mesh, place,
                                                src_data_rank=None), tree)


def fsdp_shard_tree(tree, mesh, min_size: int = 2 ** 18):
    """ZeRO-style placement: the largest dim of each leaf of at least
    ``min_size`` elements that the fsdp size divides is sharded over the
    fsdp axis, every other leaf replicated (DTensors; each rank cuts its
    share from its own copy)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    fsdp = mesh.mesh_dim_names.index("fsdp")
    size = mesh.size(fsdp)

    def place(x):
        spec = [Replicate()] * mesh.ndim
        cand = [i for i in range(x.dim()) if x.shape[i] % size == 0]
        if x.dim() and x.numel() >= min_size and cand:
            spec[fsdp] = Shard(max(cand, key=lambda i: x.shape[i]))
        return distribute_tensor(x, mesh, spec, src_data_rank=None)

    return tree_map(place, tree)


@dataclasses.dataclass(frozen=True)
class StepShard:
    """One data rank's share of a training step, handed to a step function
    as its ``noise``: the step's noise seed, this rank's ``index`` among
    ``count`` data ranks, and the data axis over which the gradients are
    averaged (None in one process). A step draws the whole batch's noise
    from ``seed`` and keeps its share (``take``), so that the shares
    together are the one-process draw."""

    seed: int
    index: int
    count: int
    axis: Any = None

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        return take_share(whole, self.index, self.count)

    def mean(self, grads):
        """The gradients averaged over the data ranks (exact for a loss
        that is the mean over the batch of equal shares)."""
        if self.axis is None or self.count == 1:
            return list(grads)
        return [g / torch.full((), self.count, dtype=g.dtype, device=g.device)
                for g in self.axis.sum(grads)]
