"""Disaggregated teacher and student pools, the counterpart of
``x2i_tpu/parallel/disaggregated.py``.

The reference splits each 8-GPU node into 2 inference ranks (the frozen
MLLM, the teachers, the teacher FLUX) and 6 training ranks, and hands
tensors across from the data loader's side thread. The default trainer
colocates both halves on one device (``train/single_chip.py``); this
module keeps the two pools, over the port's split step
(``train/distill.py``: ``make_teacher_step`` / ``make_student_step``):

* the process form (a process group exists and no ``devices`` are
  given): ranks ``[0, n_infer)`` run the teacher and send its outputs
  point to point to the train ranks; train rank j (of n_train) steps on
  its share j of each batch, served by infer rank j mod n_infer, and the
  train ranks step data-parallel (``StepShard``: the gradients averaged
  over their group);
* the one-process form (``devices``, e.g. ``["cuda:0", "cuda:0"]``): both
  pools are devices of this process; the teacher runs on the infer pool,
  one share of the batch per train member, and its outputs move to the
  train pool, whose first device takes the student step on the whole
  batch.

Each share's noise is a ``StepShard`` of the step's seed, so that the
shares' latents together are the whole batch's draw. ``train_stream``
runs the exchange in the ``PrefetchLoader`` thread, so that it overlaps
the student's step, as the reference's loader thread does.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist

from x2i_torch.core.mesh import StepShard, take_share, tree_map
from x2i_torch.parallel.axis import GroupAxis, LocalAxis


def _flatten(tree, leaves: list):
    """-> the tree's skeleton (its tensors replaced by their index in
    ``leaves``, to which they are appended)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return len(leaves) - 1
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    raise TypeError(f"cannot send a {type(tree).__name__}")


def _unflatten(skeleton, leaves: list):
    if isinstance(skeleton, int):
        return leaves[skeleton]
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    return type(skeleton)(_unflatten(v, leaves) for v in skeleton)


def send_tree(tree, dst: int, device) -> None:
    """A tree of tensors to global rank ``dst``: its skeleton, shapes and
    dtypes as one object, then the tensors."""
    leaves: list = []
    skeleton = _flatten(tree, leaves)
    meta = [(tuple(t.shape), t.dtype) for t in leaves]
    dist.send_object_list([(skeleton, meta)], dst, device=device)
    for work in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t.contiguous(), dst) for t in leaves]):
        work.wait()


def recv_tree(src: int, device):
    """The tree ``send_tree`` sent from global rank ``src``, on
    ``device``."""
    box = [None]
    dist.recv_object_list(box, src, device=device)
    skeleton, meta = box[0]
    leaves = [torch.empty(s, dtype=d, device=device) for s, d in meta]
    for work in dist.batch_isend_irecv(
            [dist.P2POp(dist.irecv, t, src) for t in leaves]):
        work.wait()
    return _unflatten(skeleton, leaves)


def _modules(frozen) -> List[torch.nn.Module]:
    if frozen is None:
        return []
    return list(frozen) if isinstance(frozen, (list, tuple)) else [frozen]


class DisaggregatedDistill:
    """Args:
      teacher_fn: (batch, noise) -> teacher outputs (a dict of tensors:
        the KD stacks, and the latents and MLLM states where the teacher
        hands them over) -- the infer ranks' loop body;
      student_fn: (state, batch, teacher_out, noise) -> (state, metrics)
        -- the train ranks' loop body;
      teacher_frozen, student_frozen: the modules each side reads (a
        module or a list), moved to its pool's first device in the
        one-process form;
      state: the trainer's state (``train/distill.py::TrainState``);
      n_infer_devices: the infer pool's size (the reference's 2 of 8);
      devices: the one-process form's devices, infer pool first.
    """

    def __init__(self, teacher_fn: Callable, student_fn: Callable,
                 teacher_frozen, student_frozen, state,
                 n_infer_devices: int = 2, devices: Optional[list] = None):
        if devices is None:
            if not dist.is_initialized():
                raise RuntimeError("the process form needs a process group; "
                                   "a one-process run passes its devices")
            n = dist.get_world_size()
        else:
            n = len(devices)
        if not 0 < n_infer_devices < n:
            raise ValueError("need at least one device in each pool")
        self.teacher_fn, self.student_fn = teacher_fn, student_fn
        self.state = state
        self.n_infer, self.n_train = n_infer_devices, n - n_infer_devices
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            self.infer = LocalAxis(self.n_infer, "infer",
                                   devs[:n_infer_devices])
            self.train = LocalAxis(self.n_train, "train",
                                   devs[n_infer_devices:])
            for mod in _modules(teacher_frozen):
                mod.to(self.infer.devices[0])
            for mod in _modules(student_frozen):
                mod.to(self.train.devices[0])
            self.device = self.train.devices[0]
            return
        # every rank makes both groups, in the same order
        rank = dist.get_rank()
        groups = [dist.new_group(list(range(n_infer_devices))),
                  dist.new_group(list(range(n_infer_devices, n)))]
        self.is_infer = rank < n_infer_devices
        pool = groups[0] if self.is_infer else groups[1]
        axis = GroupAxis(pool, "infer" if self.is_infer else "train")
        self.infer = axis if self.is_infer else None
        self.train = None if self.is_infer else axis
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))

    @property
    def process_form(self) -> bool:
        return not isinstance(self.train or self.infer, LocalAxis)

    def shares(self, batch) -> int:
        """How many shares a batch is cut into: one per train member, or
        in the one-process form one (the whole batch, as JAX replicates a
        batch the pool does not divide); the process form raises
        ValueError on such a batch."""
        lead = next(t for t in _leaves(batch) if t.dim())
        if lead.shape[0] % self.n_train == 0:
            return self.n_train
        if self.process_form:
            raise ValueError(f"batch {lead.shape[0]} must be a multiple of "
                             f"the train ranks ({self.n_train})")
        return 1

    def _share(self, batch, j: int, count: int, device):
        return tree_map(lambda x: take_share(x, j, count).to(device), batch)

    def teacher_step(self, batch, noise):
        """The teacher on the infer pool, its outputs handed to the train
        pool: -> the teacher outputs for this process's student step (the
        whole batch's in the one-process form, this train rank's share's
        in the process form; None on an infer rank)."""
        seed, count = int(noise), self.shares(batch)
        if not self.process_form:
            outs = []
            for j in range(count):
                dev = self.infer.devices[j % self.n_infer]
                out = self.teacher_fn(self._share(batch, j, count, dev),
                                      StepShard(seed, j, count))
                outs.append(tree_map(lambda x: x.to(self.device), out))
            return _concat(outs)
        if not self.is_infer:
            return recv_tree(self.train.rank % self.n_infer, self.device)
        for j in range(self.infer.rank, self.n_train, self.n_infer):
            out = self.teacher_fn(self._share(batch, j, count, self.device),
                                  StepShard(seed, j, count))
            send_tree(out, self.n_infer + j, self.device)
        return None

    def train_batch(self, batch):
        """This process's student batch: the whole batch on the train
        pool's first device, or this train rank's share."""
        if not self.process_form:
            return tree_map(lambda x: x.to(self.device), batch)
        return self._share(batch, self.train.rank, self.shares(batch),
                           self.device)

    def step(self, train_batch, teacher_out, noise):
        """The student's step on the train pool -> its metrics, the loss
        the mean over the train ranks."""
        if not self.process_form:
            self.state, metrics = self.student_fn(self.state, train_batch,
                                                  teacher_out, int(noise))
            return metrics
        if self.train is None:
            raise RuntimeError("an infer rank takes no student step")
        share = StepShard(int(noise), self.train.rank, self.n_train,
                          self.train)
        self.state, metrics = self.student_fn(self.state, train_batch,
                                              teacher_out, share)
        loss = self.train.sum([metrics["loss"]])[0] / self.n_train
        return dict(metrics, loss=loss)

    def train_stream(self, batches: Iterable, noises: Iterator,
                     prefetch: int = 2):
        """(train_batch, teacher_out) pairs with the teacher's exchange in
        the loader's thread. An infer rank's stream runs its teacher steps
        and yields nothing."""
        from x2i_torch.data.loader import PrefetchLoader

        def produce():
            for batch in batches:
                out = self.teacher_step(batch, next(noises))
                if self.process_form and self.train is None:
                    continue
                yield self.train_batch(batch), out

        return PrefetchLoader(produce(), prefetch=prefetch)


def _leaves(tree) -> list:
    leaves: list = []
    _flatten(tree, leaves)
    return leaves


def _concat(outs: list):
    """The shares' teacher outputs joined along the batch: every tensor
    but the scan-layout KD stacks (L, B, ...) along dim 0."""
    if len(outs) == 1:
        return outs[0]

    def join(path, parts):
        if isinstance(parts[0], torch.Tensor):
            dim = 1 if "teacher_aux" in path and parts[0].dim() > 1 else 0
            return torch.cat(parts, dim)
        if isinstance(parts[0], dict):
            return {k: join(path + (k,), [p[k] for p in parts])
                    for k in parts[0]}
        return type(parts[0])(join(path, list(ps)) for ps in zip(*parts))

    return join((), outs)
