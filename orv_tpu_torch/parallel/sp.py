"""Sequence-parallel communicators: the port's counterpart of the `sp` mesh axis.

The JAX package shards the video tokens over the `sp` axis of its device
mesh (`orv_tpu/parallel/mesh.py:74-81`, `:96-101`) and its ring attention
talks over that axis with `ppermute`, `psum` and `pmax` inside a
`shard_map`. Here a communicator object carries the same operations, and the
code that runs on every rank (`ops/ring_attention.py`, `ControlDiT(sp=...)`)
takes it as an argument. Its interface:

  rank, size                the calling rank and the number of ranks;
  rotate(tensors, shift=1)  each rank sends its tensors to rank + shift and
                            returns those of rank - shift (a ppermute);
  all_reduce_sum(t)         the sum over ranks, added in rank order, so
                            every rank gets the same bits;
  all_reduce_max(t)         the elementwise max over ranks;
  all_gather_seq(t, dim)    the ranks' tensors concatenated along `dim`, in
                            rank order;
  reduce_scatter_sum(t, dim) the sum over ranks, added in rank order, of
                            this rank's slice along `dim` (the dim split in
                            `size` equal slices, rank r's the r-th);
  broadcast(obj, src=0)     rank `src`'s picklable object on every rank;
  split(groups)             this rank's communicator among `groups`, a
                            partition of the ranks into tuples that every
                            rank passes alike (`parallel/mesh.py` splits the
                            world into one communicator per mesh axis).

Two implementations:

* `ProcessGroupRing` is one process per rank over `torch.distributed`
  (gloo on the CPU, NCCL on several cards): `batch_isend_irecv` for the
  rotation, `all_reduce(MAX)` for the max, `all_gather` into a list for the
  gather and for the sum (gathered, then added in rank order: a reduction
  in the backend's own order would give another rounding than `LocalRing`).
  Over gloo, CUDA tensors pass through host memory: gloo's point-to-point
  ops take CPU tensors only, and NCCL refuses two ranks on one card, so
  ranks that share a card talk over gloo. That is a correctness harness,
  not a speed.
* `LocalRing(n)` is n ranks in one process: `run(fn)` calls `fn` on n
  threads at once, one per rank, with the rank held in a thread-local.
  Tensors pass by reference through one slot per rank between waits on a
  `threading.Barrier` with a timeout. All ranks run on the caller's CUDA
  stream, so the host order the barrier gives is also the device order.
  An exception in any rank aborts the barrier, every other rank stops at
  its next collective, and `run` re-raises the first error: a failing rank
  never leaves the others waiting. `split` gives sub-rings over groups of
  those threads, each with a barrier and slots of its own; an error aborts
  them all.

A group of one rank is `SOLO`, whose collectives return their input.
gloo has no reduce-scatter of its own, so both implementations build it
from the all-gather, summing in rank order.

The differentiable collectives below (`rotate`, `all_reduce_sum`,
`all_reduce_max`, `all_gather`, `reduce_scatter_sum`,
`sum_partials`, `replicated_input`, `replicated_output`) carry the
transpose rules that `shard_map` with
`check_rep=False` applies in `orv_tpu/ops/ring_attention.py`: the rotation's
backward is the inverse rotation, the sum's a sum, the max carries no
gradient (JAX's `stop_gradient`, ring_attention.py:99-104), the gather's a
reduce-scatter and the reduce-scatter's an all-gather; at the boundary of
a ring function, the cotangent of an output every rank holds whole is
divided by the number of ranks and the cotangent of an input every rank
holds whole is summed over the ranks. `sum_partials` is a psum whose
result every rank holds whole, the two rules folded into one: its backward
sums the ranks' cotangents and divides by their number, which for the
cotangent every rank holds alike is that cotangent itself, so it returns
it without a collective. Tensor and pipeline parallelism
(`models/layers.py`, `parallel/pp.py`) use these rules and no others. The
sums go in rank order, so every rank ends a backward with the same bits.

Autograd runs the backward of CUDA tensors on a worker thread of its own,
one a device, not on the thread that called `backward()`. `LocalRing`'s
ranks are threads told apart by a thread-local, and one rank's wait at a
collective there would block the others' backward, so `LocalRing` refuses
to record a differentiable collective on CUDA: run such ranks as
processes (`ProcessGroupRing`). On the CPU the calling thread runs the
backward, and `LocalRing` carries it.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import os
import threading
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def _sum_in_rank_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _rank_slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


class _Solo:
    """The communicator of a group of one rank: every collective returns
    its input."""

    rank, size = 0, 1

    def rotate(self, tensors, shift: int = 1):
        return list(tensors)

    def all_reduce_sum(self, t):
        return t

    def all_reduce_max(self, t):
        return t

    def all_gather_seq(self, t, dim: int):
        return t

    def reduce_scatter_sum(self, t, dim: int):
        return t

    def broadcast(self, obj, src: int = 0):
        return obj

    def split(self, groups):
        return self


SOLO = _Solo()


class LocalRing:
    """`n` ranks as threads of this process (see the module docstring).
    `timeout` (seconds) bounds every wait at a collective."""

    def __init__(self, n: int, timeout: float = 300.0):
        if n < 1:
            raise ValueError(f"LocalRing needs at least one rank, got {n}")
        self.size = n
        self.timeout = timeout
        self._barrier = threading.Barrier(n, timeout=timeout)
        self._slots: List[object] = [None] * n
        self._local = threading.local()
        self._subs: dict = {}  # groups -> {group: sub-ring}, shared by the rank threads
        self._subs_lock = threading.Lock()

    def _barriers(self):
        yield self._barrier
        for subs in self._subs.values():
            for sub in subs.values():
                if isinstance(sub, _SubRing):
                    yield sub._barrier

    def split(self, groups: Sequence[Sequence[int]]):
        """This rank's sub-ring among `groups` (module docstring), or a group
        of its own when no group names it: every rank thread that passes the
        same groups gets the same sub-ring objects."""
        key = tuple(tuple(g) for g in groups)
        with self._subs_lock:
            subs = self._subs.get(key)
            if subs is None:
                subs = self._subs[key] = {g: _SubRing(self, g) if len(g) > 1 else SOLO
                                          for g in key}
        return next((sub for g, sub in subs.items() if self.rank in g), SOLO)

    @property
    def rank(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("LocalRing: rank is defined only inside LocalRing.run")
        return rank

    def run(self, fn: Callable[[], object]) -> list:
        """Call `fn()` once on each of `size` threads, one per rank, and
        return the ranks' results in rank order. Each thread takes the
        caller's grad mode, inference mode and CUDA stream. If any rank
        raises, every rank is stopped and the first error is raised here."""
        for barrier in self._barriers():
            if barrier.broken:
                barrier.reset()
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
        stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(rank: int) -> None:
            self._local.rank = rank
            try:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(torch.inference_mode(inference))
                    stack.enter_context(torch.set_grad_enabled(grad))
                    if stream is not None:
                        stack.enter_context(torch.cuda.stream(stream))
                    results[rank] = fn()
            except BaseException as e:  # noqa: BLE001 - re-raised by run
                errors[rank] = e
                for barrier in self._barriers():
                    barrier.abort()
            finally:
                self._local.rank = None

        threads = [threading.Thread(target=body, args=(r,), name=f"LocalRing-rank{r}",
                                    daemon=True) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * self.size
        failed = [e for e in errors if e is not None]
        if failed:
            # the rank that failed first is the cause; the others saw a broken barrier
            cause = next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                         failed[0])
            raise cause
        return results

    def _exchange(self, value) -> list:
        """Every rank's `value`, in rank order, once all ranks have posted."""
        self._slots[self.rank] = value
        self._barrier.wait()
        values = list(self._slots)
        self._barrier.wait()  # nobody posts the next value before all have read
        return values

    def rotate(self, tensors: Sequence[torch.Tensor], shift: int = 1) -> List[torch.Tensor]:
        if self.size == 1:
            return list(tensors)
        return list(self._exchange(list(tensors))[(self.rank - shift) % self.size])

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _sum_in_rank_order(self._exchange(t))

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(t)).amax(0)

    def all_gather_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._exchange(t), dim=dim)

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        parts = self._exchange(t)
        return _sum_in_rank_order([_rank_slice(p, dim, self.rank, self.size) for p in parts])

    def broadcast(self, obj, src: int = 0):
        """Rank `src`'s `obj`; the other ranks get a deep copy of it."""
        value = self._exchange(obj if self.rank == src else None)[src]
        return value if self.rank == src else copy.deepcopy(value)


class _SubRing(LocalRing):
    """The ranks `members` of a `LocalRing` (parent ranks, in this order):
    a barrier and slots of their own; `run` stays the parent's."""

    def __init__(self, parent: LocalRing, members: Sequence[int]):
        self.parent, self.members = parent, tuple(members)
        self.size, self.timeout = len(self.members), parent.timeout
        self._barrier = threading.Barrier(self.size, timeout=parent.timeout)
        self._slots = [None] * self.size

    @property
    def rank(self) -> int:
        return self.members.index(self.parent.rank)

    def run(self, fn):
        raise RuntimeError("run the parent LocalRing: a sub-ring's ranks are its threads")

    def split(self, groups):
        raise RuntimeError("split the parent LocalRing")


class ProcessGroupRing:
    """One rank per process over a `torch.distributed` process group
    (`group=None`: the default one). Create the group with a finite
    timeout, as `init_process_group` below does, so a rank that dies leaves
    the others with an error and not a hang. Over gloo, CUDA tensors are
    staged through host memory (module docstring)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._via_host = dist.get_backend(group) == "gloo"
        self._subs: dict = {}

    @staticmethod
    def init_process_group(backend: str, init_method: str, world_size: int, rank: int,
                           timeout: float = 120.0) -> "ProcessGroupRing":
        """`torch.distributed.init_process_group` with a timeout of `timeout`
        seconds, then the ring over the default group. `init_method` is an
        address such as "tcp://localhost:29500": nothing tells a process of
        its peers otherwise."""
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout))
        return ProcessGroupRing()

    @staticmethod
    def from_env(timeout: float = 600.0) -> Optional["ProcessGroupRing"]:
        """Under `torchrun` (WORLD_SIZE > 1 in the environment): pick this
        rank's card, start the default group from the environment's address
        and return the ring over it; else None. NCCL where every rank has a
        card of its own, else gloo (the ranks share a card or run on the
        CPU)."""
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return None
        if dist.is_initialized():
            return ProcessGroupRing()
        rank = int(os.environ["RANK"])
        cards = torch.cuda.device_count()
        if cards:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % cards)
        backend = "nccl" if cards >= world else "gloo"
        return ProcessGroupRing.init_process_group(backend, "env://", world, rank, timeout)

    def _peer(self, rank: int) -> int:
        rank %= self.size
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self._via_host and t.is_cuda else t

    def rotate(self, tensors: Sequence[torch.Tensor], shift: int = 1) -> List[torch.Tensor]:
        if self.size == 1:
            return list(tensors)
        sends = [self._host(t) for t in tensors]
        outs = [torch.empty_like(t) for t in sends]
        ops = []
        for t, o in zip(sends, outs):
            ops.append(dist.P2POp(dist.isend, t, self._peer(self.rank + shift), self.group))
            ops.append(dist.P2POp(dist.irecv, o, self._peer(self.rank - shift), self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [o.to(t.device) for o, t in zip(outs, tensors)]

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        h = self._host(t)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.group)
        return [p.to(t.device) for p in parts]

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _sum_in_rank_order(self._gather(t))

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        out = self._host(t).clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out.to(t.device)

    def all_gather_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._gather(t), dim=dim)

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _sum_in_rank_order([_rank_slice(p, dim, self.rank, self.size)
                                   for p in self._gather(t)])

    def broadcast(self, obj, src: int = 0):
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=self._peer(src), group=self.group)
        return box[0]

    def split(self, groups: Sequence[Sequence[int]]):
        """This rank's communicator among `groups` (ranks of the default
        group): every process creates every group of more than one rank,
        in the order given, as `torch.distributed.new_group` requires, so
        every process must pass the same groups."""
        if self.group is not None:
            raise ValueError("split the ring over the default group")
        key = tuple(tuple(g) for g in groups)
        if key not in self._subs:
            mine = SOLO
            for g in key:
                if len(g) > 1:
                    pg = dist.new_group(list(g))  # every process creates every group
                    if self.rank in g:
                        mine = ProcessGroupRing(pg)
            self._subs[key] = mine
        return self._subs[key]


def resolve_ranks(n: int, comm, what: str):
    """The communicator of `n` ranks that `what` (a config key) asks for:
    `comm` when given, else a `ProcessGroupRing` over the default
    `torch.distributed` group when that has `n` ranks. Raises, naming the
    cause, when there are not `n` ranks."""
    if comm is not None:
        if comm.size != n:
            raise ValueError(f"{what}={n} but the communicator passed has {comm.size} ranks")
        return comm
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"{what}={n} needs {n} ranks, and this process has {world}: pass a communicator "
            f"of {n} ranks (comm=LocalRing({n}) inside its run, or a ProcessGroupRing), or start "
            f"{n} processes under a torch.distributed group of world size {n} "
            f"(torchrun --nproc_per_node {n})")
    return ProcessGroupRing()


_init_lock = threading.Lock()


@contextlib.contextmanager
def seeded_init(seed: int, device: torch.device):
    """PyTorch's global generators seeded with `seed` inside the block and
    restored after it. Ranks that are threads of one process (`LocalRing`)
    share those generators, so they take the block in turns: each rank's
    model then starts from the same weights."""
    with _init_lock, torch.random.fork_rng(
            devices=[device.index or 0] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        yield


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

def _check_backward(comm, tensors: Sequence[torch.Tensor], what: str) -> bool:
    """Whether autograd records `what` on these tensors; raises where
    `LocalRing` would have to carry that backward on CUDA."""
    recorded = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if recorded and isinstance(comm, LocalRing) and any(t.is_cuda for t in tensors):
        raise RuntimeError(
            f"{what}: LocalRing cannot carry a backward on CUDA: autograd runs CUDA backward "
            "nodes on its own device thread, where a LocalRing rank is unknown and one rank's "
            "wait at a collective blocks the others; run the ranks as processes "
            "(ProcessGroupRing), or run under torch.no_grad()")
    return recorded


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, shift, *tensors):
        ctx.comm, ctx.shift = comm, shift
        return tuple(t.detach() for t in comm.rotate(tensors, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.comm.rotate([g.contiguous() for g in grads], -ctx.shift))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return comm.all_reduce_sum(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce_sum(g.contiguous())


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather_seq(t, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.reduce_scatter_sum(g.contiguous(), ctx.dim), None


class _ReduceScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.reduce_scatter_sum(t.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_gather_seq(g.contiguous(), ctx.dim), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t):
        return comm.all_reduce_sum(t)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce_sum(g.contiguous())


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t):
        ctx.size = comm.size
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, g / ctx.size


def rotate(comm, tensors: Sequence[torch.Tensor], shift: int = 1) -> List[torch.Tensor]:
    """`comm.rotate`, differentiable: the backward sends each cotangent back
    to the rank it came from (rank - shift)."""
    if comm.size == 1:
        return list(tensors)
    if not _check_backward(comm, tensors, "rotate"):
        return comm.rotate(tensors, shift)
    return list(_Rotate.apply(comm, shift, *tensors))


def all_reduce_sum(comm, t: torch.Tensor) -> torch.Tensor:
    """`comm.all_reduce_sum`, differentiable: the backward sums the ranks'
    cotangents (the transpose of psum)."""
    if comm.size == 1:
        return t
    if not _check_backward(comm, [t], "all_reduce_sum"):
        return comm.all_reduce_sum(t)
    return _AllReduceSum.apply(comm, t)


def all_reduce_max(comm, t: torch.Tensor) -> torch.Tensor:
    """`comm.all_reduce_max` of `t` detached: the max carries no gradient."""
    return t.detach() if comm.size == 1 else comm.all_reduce_max(t.detach())


def all_gather(comm, t: torch.Tensor, dim: int) -> torch.Tensor:
    """`comm.all_gather_seq`, differentiable: the backward is a
    reduce-scatter (this rank's slice of the cotangent, summed over the
    ranks in rank order)."""
    if comm.size == 1:
        return t
    if not _check_backward(comm, [t], "all_gather"):
        return comm.all_gather_seq(t, dim)
    return _AllGatherSeq.apply(comm, t, dim)


def reduce_scatter_sum(comm, t: torch.Tensor, dim: int) -> torch.Tensor:
    """`comm.reduce_scatter_sum`, differentiable: the backward all-gathers
    the cotangent."""
    if comm.size == 1:
        return t
    if not _check_backward(comm, [t], "reduce_scatter_sum"):
        return comm.reduce_scatter_sum(t.contiguous(), dim)
    return _ReduceScatterSum.apply(comm, t, dim)


def sum_partials(comm, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of their partial results `t`, which every
    rank then holds whole (a psum at a replicated output, module
    docstring): the forward adds in rank order, the backward returns the
    cotangent as it is."""
    if comm.size == 1:
        return t
    if not _check_backward(comm, [t], "sum_partials"):
        return comm.all_reduce_sum(t)
    return _SumPartials.apply(comm, t)


def replicated_input(comm, t: torch.Tensor) -> torch.Tensor:
    """`t`, a tensor that every rank holds whole, entering per-rank code:
    the backward sums its cotangent over the ranks."""
    if comm.size == 1 or not _check_backward(comm, [t], "replicated_input"):
        return t
    return _ReplicatedInput.apply(comm, t)


def replicated_output(comm, t: torch.Tensor) -> torch.Tensor:
    """`t`, a result that every rank holds whole: the backward divides its
    cotangent by the number of ranks."""
    if comm.size == 1 or not _check_backward(comm, [t], "replicated_output"):
        return t
    return _ReplicatedOutput.apply(comm, t)
