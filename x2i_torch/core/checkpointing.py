"""Step-directory checkpoints with the reference's resume semantics, the
counterpart of ``x2i_tpu/core/checkpointing.py``.

One directory per step, ``{output_dir}/{step}/``, and resume from the
largest all-digit directory name, as the reference and JAX keep them.
Orbax is JAX's, so the port has a format of its own: ``state.pt``, a
``torch.save`` of a tree of dicts and lists of CPU tensors, Python ints
and floats and None, read back with ``torch.load(weights_only=True)``. A
save writes a temporary directory beside the steps and ``os.replace``s it
into place, so that a killed save leaves no half step; ``max_to_keep``
deletes the oldest step directories.

A state is turned into such a tree by ``to_tree`` (a dataclass becomes
the dict of its fields, an ``nn.Module`` its ``state_dict``, a tensor a
CPU copy) and filled back by ``fill``, which puts each tensor on the
device of the one it replaces and loads modules in place.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import tempfile
from typing import Any, Optional

import torch
from torch import nn

_NUM_RE = re.compile(r"^\d+$")
STATE_FILE = "state.pt"


def latest_step(output_dir: str) -> Optional[int]:
    """The largest all-digit subdirectory name, or None (the reference's
    get_max_numbered_filename)."""
    if not os.path.isdir(output_dir):
        return None
    steps = [int(d) for d in os.listdir(output_dir) if _NUM_RE.match(d)]
    return max(steps) if steps else None


def to_tree(obj: Any) -> Any:
    """A state as dicts, lists, CPU tensors and Python scalars: a
    snapshot, whose tensors are copies also of CPU tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, nn.Module):
        return {k: to_tree(v) for k, v in obj.state_dict().items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_tree(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_tree(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def fill(template: Any, tree: Any) -> Any:
    """``template`` with the values of ``tree`` (``to_tree``'s form of a
    state like it): tensors on the template's devices, modules loaded in
    place, dataclasses replaced. Raises ValueError where the two differ in
    structure, shape or dtype."""
    if isinstance(template, torch.Tensor):
        if (not isinstance(tree, torch.Tensor)
                or tree.shape != template.shape
                or tree.dtype != template.dtype):
            got = (f"{tuple(tree.shape)} {tree.dtype}"
                   if isinstance(tree, torch.Tensor) else repr(tree))
            raise ValueError(f"checkpoint: {got} does not fill a tensor "
                             f"{tuple(template.shape)} {template.dtype}")
        return tree.to(template.device)
    if isinstance(template, nn.Module):
        template.load_state_dict(tree)
        return template
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: fill(getattr(template, f.name), tree[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, list) or len(tree) != len(template):
            raise ValueError("checkpoint: a list of another length")
        return type(template)(fill(t, x) for t, x in zip(template, tree))
    if isinstance(template, dict):
        return {k: fill(v, tree[k]) for k, v in template.items()}
    if (template is None) != (tree is None):
        raise ValueError(f"checkpoint: {tree!r} does not fill {template!r}")
    return tree


class CheckpointManager:
    """Step-directory checkpoints of a training state (the trainable
    module, the step, the optimizer state)."""

    def __init__(self, output_dir: str, max_to_keep: Optional[int] = 5):
        self.output_dir = os.path.abspath(output_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.output_dir, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.output_dir, str(step))

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as step ``step`` (a step already on disk is kept,
        as orbax keeps it), then drop the oldest beyond ``max_to_keep``."""
        if os.path.isdir(self._dir(step)):
            return
        tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=self.output_dir)
        try:
            torch.save(to_tree(state), os.path.join(tmp, STATE_FILE))
            os.replace(tmp, self._dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            steps = sorted(int(d) for d in os.listdir(self.output_dir)
                           if _NUM_RE.match(d))
            for old in steps[:-self.max_to_keep]:
                shutil.rmtree(self._dir(old))

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None) -> Any:
        """Step ``step`` (the latest by default; None if there is none):
        ``to_tree``'s form, or with ``template`` that state filled."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        tree = torch.load(os.path.join(self._dir(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
        return tree if template is None else fill(template, tree)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.output_dir)

    def close(self):
        """Nothing to wait for: every save is written when it returns."""
