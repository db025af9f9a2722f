"""GPipe pipeline parallelism over a mesh axis, the counterpart of
``x2i_tpu/parallel/pipeline.py``.

Each member of the axis (a stage) holds a contiguous chunk of a layer
list, and microbatches stream through the stages: at step t stage s works
on microbatch t - s, and its output hops to stage s + 1, so that every
stage works on a different microbatch (M + S - 1 steps for M microbatches
and S stages; the bubble is (S - 1) / (M + S - 1)). The last stage's
outputs are then given to every stage.

The schedule is written once over the stages this process holds
(``parallel/axis.py``): all of them in the one-process form, one in the
process form. A stage with no microbatch at a step (a bubble) computes
nothing, where JAX's branchless loop computes values it throws away: the
results are the same. Differentiable in both forms; in the process form
the hops, the replicated input and the last broadcast are autograd
``Function``s (see ``parallel/axis.py`` for how to take the backward).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence


def pipeline_scan(stage_fn: Callable[[Any, tuple], tuple],
                  stage_params: Sequence[Any], xs: List[tuple], axis
                  ) -> List[tuple]:
    """Runs the microbatches ``xs`` (a list of M tuples of tensors, the
    same on every stage; only stage 0 reads them) through the stages.
    ``stage_params`` holds, for each member this process holds, the
    argument its ``stage_fn(params, activation) -> activation`` takes (an
    activation keeps its tensors' shapes and dtypes). -> the M outputs, on
    every stage."""
    n_stages, n_micro = axis.size, len(xs)
    xs, tape = axis.enter(xs)
    like = xs[0]
    recv = [None] * len(axis.members)
    outs: List[Any] = [None] * n_micro

    def active(stage: int, step: int) -> bool:
        return 0 <= step - stage < n_micro

    for t in range(n_micro + n_stages - 1):
        sent = []
        for i, s in enumerate(axis.members):
            if not active(s, t):
                sent.append(None)
                continue
            inp = xs[t - s] if s == 0 else recv[i]
            out = tuple(stage_fn(stage_params[i], inp))
            if s == n_stages - 1:
                outs[t - s] = out
            sent.append(out)
        recv = axis.shift(sent, senders=lambda s, t=t: active(s, t),
                          wrap=False, like=like, tape=tape)
    last = [tuple(t for out in outs for t in out)
            if s == n_stages - 1 else None for s in axis.members]
    flat = axis.broadcast(last, n_stages - 1,
                          like=tuple(t for x in xs for t in x), tape=tape)[0]
    width = len(like)
    return [tuple(flat[m * width:(m + 1) * width]) for m in range(n_micro)]


def split_stages(layers: Sequence[Any], n_stages: int) -> List[list]:
    """``layers`` cut into ``n_stages`` contiguous chunks; raises when they
    do not divide."""
    if len(layers) % n_stages:
        raise ValueError(f"pipeline_apply: {len(layers)} layers not "
                         f"divisible by {n_stages} stages")
    per = len(layers) // n_stages
    return [list(layers[i * per:(i + 1) * per]) for i in range(n_stages)]


def pipeline_apply(stage_fn: Callable[[list, tuple], tuple],
                   layers: Sequence[Any], xs: List[tuple], axis
                   ) -> List[tuple]:
    """The layer list cut into one contiguous chunk per stage, each
    member's chunk handed to ``stage_fn`` as its params: -> the M outputs
    of ``pipeline_scan``."""
    chunks = split_stages(layers, axis.size)
    return pipeline_scan(stage_fn, [chunks[m] for m in axis.members], xs,
                         axis)
