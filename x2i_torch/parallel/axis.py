"""A mesh axis as one process holds it: the counterpart of JAX's
``ppermute``, ``psum`` and ``axis_index`` over a named mesh axis.

JAX's parallel code is single-controller: one process holds the whole
mesh, and a ``shard_map`` body sees one member of an axis. PyTorch runs one
process per device. The collective schedules of the port (the ring, the
GPipe schedule, the pools' exchange) are written once, over the members
of an axis that this process holds, and an axis comes in two forms:

* ``GroupAxis`` -- the process form: this process is one member, the
  members are the ranks of a process group (``DeviceMesh.get_group``). A
  shift is a ``batch_isend_irecv`` to the next rank and from the previous
  one, a broadcast and a sum are the group's collectives. Without a group
  it raises; it never runs the one-process form instead.
* ``LocalAxis`` -- the one-process form: this process holds all ``size``
  members, as a list, each on its device (by default one device for all).
  A shift is a roll of the list. It is the counterpart of JAX's mesh over
  the virtual devices of one process, and on one card the only way to run
  the ring's pair kernels or a pipeline of stages.

Values are lists aligned with ``members``, each a tuple of tensors (or
None where a member has nothing). The results do not depend on the form:
the same operations run on each member in the same order, and a transfer
is exact.

The tensor-parallel collectives (``split``, ``gather``, ``psum``,
``psum_scatter``, ``pmax``) take and give one tensor a member (lists
aligned with ``members``) or one replicated tensor. ``psum`` and
``psum_scatter`` add floating parts in member order in f32, in both forms
(the process form gathers the parts first, where an ``all_reduce`` would
add them in NCCL's order), so that the two forms agree bit for bit;
integer parts (the int32 accumulators of the quantized products) they add
exactly in their own dtype, which any order gives, so the process form
takes ``all_reduce`` / ``reduce_scatter`` for them. ``pmax`` is the
elementwise max, exact in any order (``all_reduce(MAX)``). Every rank
calls them in the same order: NCCL pairs messages by order. In the
process form they are not differentiable and refuse a tensor that
requires grad; the one-process form's are ordinary tensor operations.

Under autograd the process form's transfers are ``autograd.Function``s:
a hop sends forward and receives the gradient backward, ``enter`` marks a
replicated input whose gradient is summed over the axis, and ``broadcast``
hands the source's gradient back. A ``Tape`` chains one schedule's entry,
hops and broadcast through a token that each takes from the one before,
so that every rank runs the backward of every hop, one after another in
reverse order, whichever of autograd's threads runs it (a hop's peer
receives in that order: a hop run out of turn hands it another hop's
gradient). The backward is then a ``loss.backward()`` on every rank
(``autograd.grad`` may skip the hops of inputs it is not asked for, and a
skipped hop leaves its peer waiting until the group's timeout).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

Value = Optional[Sequence[torch.Tensor]]


class Tape:
    """One schedule's chain in the process form: ``token`` is the last
    link (from ``enter``, then from each hop), an input of the next hop
    and of the schedule's broadcast."""

    def __init__(self, token: torch.Tensor):
        self.token = token


class Axis:
    """What both forms share: ``name``, ``size`` and the indices of the
    members this process holds (``members``)."""

    name: str
    size: int
    members: tuple

    def senders_default(self, _member: int) -> bool:
        return True

    def sends(self, member: int, senders, wrap: bool) -> bool:
        return bool(senders(member)) and (wrap or member < self.size - 1)

    def share(self, n: int, what: str) -> int:
        """A member's share of ``n`` ``what``; raises ValueError naming
        the count where the size does not divide it."""
        if n % self.size:
            raise ValueError(f"{n} {what} do not split over the "
                             f"{self.size} members of axis {self.name!r}")
        return n // self.size

    def split(self, x: torch.Tensor, dim: int,
              what: str = "tokens") -> List[torch.Tensor]:
        """Each held member's share of a replicated ``x`` along ``dim``
        (member m the m-th of ``size`` equal blocks)."""
        step = self.share(x.shape[dim], what)
        return [x.narrow(dim, m * step, step) for m in self.members]


def _sum_f32(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parts added in their order in f32, in the first part's dtype;
    integer parts added exactly in their dtype."""
    if not parts[0].is_floating_point():
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(parts[0].dtype)


def _max(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p)
    return acc


class LocalAxis(Axis):
    """The one-process form: all ``size`` members in this process, member
    i on ``devices[i]`` (default: wherever its values lie)."""

    def __init__(self, size: int, name: str = "", devices=None):
        if size < 1:
            raise ValueError(f"an axis has at least one member, got {size}")
        if devices is not None and len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} members")
        self.name, self.size = name, size
        self.members = tuple(range(size))
        self.devices = None if devices is None else [torch.device(d)
                                                     for d in devices]

    def __repr__(self):
        return f"LocalAxis({self.size}, {self.name!r})"

    def _to(self, member: int, value):
        if value is None or self.devices is None:
            return value
        return tuple(t.to(self.devices[member]) for t in value)

    def enter(self, xs):
        """A replicated input of a schedule: -> (xs, None), the gradient
        summed by autograd over the members that read it."""
        return xs, None

    def shift(self, values: List[Value], senders: Optional[Callable] = None,
              wrap: bool = True, like=None, tape=None) -> List[Value]:
        """Member m sends values[m] to member m + 1 (from the last to the
        first with ``wrap``) where ``senders(m)``; -> what each member
        receives (None where its predecessor sent nothing)."""
        senders = senders or self.senders_default
        out = []
        for m in self.members:
            p = (m - 1) % self.size
            if (wrap or m > 0) and self.sends(p, senders, wrap):
                out.append(self._to(m, values[p]))
            else:
                out.append(None)
        return out

    def broadcast(self, values: List[Value], src: int, like=None,
                  tape=None) -> List[Value]:
        """Every member's copy of member ``src``'s value."""
        return [self._to(m, values[src]) for m in self.members]

    def gather(self, tensors: List[torch.Tensor], dim: int) -> torch.Tensor:
        """The members' tensors concatenated along ``dim`` in member
        order, on the first member's device."""
        dev = tensors[0].device
        return torch.cat([t.to(dev) for t in tensors], dim)

    def psum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The members' parts summed (in member order, in f32; integer
        parts exactly), on the first member's device."""
        dev = parts[0].device
        return _sum_f32([t.to(dev) for t in parts])

    def pmax(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The members' tensors' elementwise max, on the first member's
        device."""
        dev = parts[0].device
        return _max([t.to(dev) for t in parts])

    def psum_scatter(self, parts: List[torch.Tensor], dim: int,
                     what: str = "tokens") -> List[torch.Tensor]:
        """Each member's share along ``dim`` of the members' parts summed
        (``psum``, then ``split``)."""
        return self.split(self.psum(parts), dim, what)

    def split(self, x: torch.Tensor, dim: int,
              what: str = "tokens") -> List[torch.Tensor]:
        """``Axis.split``, each share on its member's device."""
        shares = super().split(x, dim, what)
        if self.devices is None:
            return shares
        return [t.to(d) for t, d in zip(shares, self.devices)]


class GroupAxis(Axis):
    """The process form: this process is member ``dist.get_rank(group)``
    of the group's ``size``."""

    def __init__(self, group, name: str = ""):
        if group is None or not dist.is_initialized():
            raise RuntimeError(
                f"the process form of axis {name!r} needs a process group "
                f"(torch.distributed is not initialized); a one-process "
                f"run takes a LocalAxis")
        self.group, self.name = group, name
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.members = (self.rank,)

    def __repr__(self):
        return f"GroupAxis(rank {self.rank} of {self.size}, {self.name!r})"

    def peer(self, member: int) -> int:
        """The global rank of ``member``."""
        return dist.get_global_rank(self.group, member)

    # ---------------------------------------------------------- transfers

    def _p2p(self, send_to, sent, recv_from, like) -> Value:
        """Sends the tensors ``sent`` to member ``send_to`` and receives
        tensors shaped as ``like`` from ``recv_from`` (either may be None),
        in one batch."""
        ops, got = [], None
        if send_to is not None:
            ops += [dist.P2POp(dist.isend, t.contiguous(),
                               self.peer(send_to), self.group) for t in sent]
        if recv_from is not None:
            got = tuple(torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in like)
            ops += [dist.P2POp(dist.irecv, t, self.peer(recv_from),
                               self.group) for t in got]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got

    def enter(self, xs):
        """A replicated input of a schedule: -> (xs, tape). Under autograd
        the tape's chain starts here: the input's gradient is summed over
        the group once every hop has run."""
        if not torch.is_grad_enabled():
            return xs, None
        flat = [t for x in xs for t in x]
        dummy = torch.zeros((), requires_grad=True)
        token, *out = _Enter.apply(self, dummy, *flat)
        it = iter(out)
        return [tuple(next(it) for _ in x) for x in xs], Tape(token)

    def shift(self, values: List[Value], senders: Optional[Callable] = None,
              wrap: bool = True, like=None, tape: Optional[Tape] = None
              ) -> List[Value]:
        """As ``LocalAxis.shift`` for this rank's one value; ``like`` gives
        the received tensors' shapes where this rank sends nothing."""
        senders = senders or self.senders_default
        me, n = self.rank, self.size
        value = values[0]
        send = value is not None and self.sends(me, senders, wrap)
        prev = (me - 1) % n
        recv = (wrap or me > 0) and self.sends(prev, senders, wrap)
        if n == 1:
            return [value if send and recv else None]
        send_to = (me + 1) % n if send else None
        recv_from = prev if recv else None
        like = value if value is not None else like
        if tape is None or (send_to is None and recv_from is None):
            return [self._p2p(send_to, value, recv_from, like)]
        sent = tuple(value) if send else ()
        tape.token, *got = _Hop.apply(self, send_to, recv_from, like,
                                      tape.token, *sent)
        return [tuple(got) if recv else None]

    def broadcast(self, values: List[Value], src: int, like=None,
                  tape: Optional[Tape] = None) -> List[Value]:
        """Member ``src``'s value on this rank (``like`` gives its shapes
        elsewhere). Under a tape the gradient of the source's copy is the
        source's own: every rank computes the same replicated result."""
        if self.size == 1:
            return values
        value = values[0] if self.rank == src else like
        if tape is None:
            return [_broadcast(self, src, value)]
        out = _Broadcast.apply(self, src, tape.token, *value)
        return [tuple(out)]

    def gather(self, tensors: List[torch.Tensor], dim: int) -> torch.Tensor:
        """All members' tensors (each the same shape) concatenated along
        ``dim`` in member order, on every rank."""
        if self.size == 1:
            return tensors[0]
        t = tensors[0].contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def psum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """This rank's part summed with the other members' (gathered, then
        added in member order in f32: ``LocalAxis.psum``'s bits; integer
        parts by ``all_reduce``, exact)."""
        t = _refuse_grad(self, "psum", parts[0])
        if self.size == 1:
            return t
        if not t.is_floating_point():
            out = t.contiguous().clone()
            dist.all_reduce(out, group=self.group)
            return out
        gathered = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(gathered, t.contiguous(), group=self.group)
        return _sum_f32(gathered)

    def psum_scatter(self, parts: List[torch.Tensor], dim: int,
                     what: str = "tokens") -> List[torch.Tensor]:
        """This rank's share along ``dim`` of the members' parts summed:
        each rank sends member m its m-th block (``all_to_all``) and adds
        the blocks it receives in member order in f32 (integer parts by
        ``reduce_scatter``, exact)."""
        t = _refuse_grad(self, "psum_scatter", parts[0])
        if self.size == 1:
            return [t]
        step = self.share(t.shape[dim], what)
        blocks = [b.contiguous() for b in t.split(step, dim)]
        if not t.is_floating_point():
            out = torch.empty_like(blocks[0])
            dist.reduce_scatter(out, blocks, group=self.group)
            return [out]
        got = [torch.empty_like(b) for b in blocks]
        dist.all_to_all(got, blocks, group=self.group)
        return [_sum_f32(got)]

    def pmax(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """This rank's tensor's elementwise max with the other members'
        (``all_reduce(MAX)``: exact in any order)."""
        t = _refuse_grad(self, "pmax", parts[0])
        out = t.contiguous().clone()
        if self.size > 1:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor summed over the group (new tensors)."""
        out = [t.detach().clone() for t in tensors]
        if self.size > 1:
            for t in out:
                dist.all_reduce(t, group=self.group)
        return out


def _refuse_grad(axis: GroupAxis, name: str, t: torch.Tensor):
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(
            f"{name} over the process form of axis {axis.name!r} has no "
            f"backward: its gradient would be silently wrong; the "
            f"one-process form (LocalAxis) differentiates")
    return t


def _broadcast(axis: GroupAxis, src: int, value) -> tuple:
    out = tuple(t.contiguous().clone() if axis.rank == src else
                torch.empty_like(t, memory_format=torch.contiguous_format)
                for t in value)
    for t in out:
        dist.broadcast(t, axis.peer(src), group=axis.group)
    return out


class _Enter(torch.autograd.Function):
    """Identity on a schedule's replicated input; backward: its gradient
    summed over the group. Its token starts the tape's chain, so that the
    sum runs after every hop, on every rank."""

    @staticmethod
    def forward(ctx, axis, dummy, *xs):
        ctx.axis = axis
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in xs]
        return (dummy.new_zeros(()), *xs)

    @staticmethod
    def backward(ctx, _g_token, *g_xs):
        grads = [torch.zeros(s, dtype=d, device=dev) if g is None else g
                 for g, (s, d, dev) in zip(g_xs, ctx.shapes)]
        return (None, None, *ctx.axis.sum(grads))


class _Hop(torch.autograd.Function):
    """One hop of a shift in the process form: forward sends ``sent`` to
    ``send_to`` and receives from ``recv_from``; backward sends the
    received tensors' gradients back to ``recv_from`` and receives the
    sent tensors' from ``send_to``. It takes the tape's token and gives
    the next one, so that its backward runs after the next hop's."""

    @staticmethod
    def forward(ctx, axis, send_to, recv_from, like, token, *sent):
        ctx.axis, ctx.send_to, ctx.recv_from = axis, send_to, recv_from
        ctx.sent = [(t.shape, t.dtype, t.device) for t in sent]
        ctx.recv = [(t.shape, t.dtype, t.device) for t in like]
        got = axis._p2p(send_to, sent, recv_from, like)
        return (token.new_zeros(()), *(got or ()))

    @staticmethod
    def backward(ctx, g_token, *g_got):
        g_recv = None
        if ctx.recv_from is not None:
            g_recv = [torch.zeros(s, dtype=d, device=dev) if g is None
                      else g for g, (s, d, dev) in zip(g_got, ctx.recv)]
        back_like = [torch.empty(s, dtype=d, device=dev)
                     for s, d, dev in ctx.sent]
        g_sent = ctx.axis._p2p(ctx.recv_from, g_recv, ctx.send_to, back_like)
        return (None, None, None, None, torch.zeros_like(g_token),
                *(g_sent or ()))


class _Broadcast(torch.autograd.Function):
    """The source's value on every rank, at the end of the tape's chain;
    backward: the source's gradient to its own input, none elsewhere."""

    @staticmethod
    def forward(ctx, axis, src, token, *value):
        ctx.is_src, ctx.n = axis.rank == src, len(value)
        return _broadcast(axis, src, value)

    @staticmethod
    def backward(ctx, *g_out):
        g_value = g_out if ctx.is_src else (None,) * ctx.n
        return (None, None, torch.zeros(()), *g_value)
