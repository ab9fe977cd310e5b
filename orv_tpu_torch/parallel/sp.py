"""Sequence-parallel communicators: the port's counterpart of the `sp` mesh axis.

The JAX package shards the video tokens over the `sp` axis of its device
mesh (`orv_tpu/parallel/mesh.py:74-81`, `:96-101`) and its ring attention
talks over that axis with `ppermute`, `psum` and `pmax` inside a
`shard_map`. Here a communicator object carries the same operations, and the
code that runs on every rank (`ops/ring_attention.py`, `ControlDiT(sp=...)`)
takes it as an argument. Its interface:

  rank, size                the calling rank and the number of ranks;
  rotate(tensors)           each rank sends its tensors to rank + 1 and
                            returns those of rank - 1 (a ppermute);
  all_reduce_sum(t)         the sum over ranks, added in rank order, so
                            every rank gets the same bits;
  all_reduce_max(t)         the elementwise max over ranks;
  all_gather_seq(t, dim)    the ranks' tensors concatenated along `dim`, in
                            rank order.

Two implementations:

* `ProcessGroupRing` is one process per rank over `torch.distributed`
  (gloo on the CPU, NCCL on several cards): `batch_isend_irecv` for the
  rotation, `all_reduce(MAX)` for the max, `all_gather` into a list for the
  gather and for the sum (gathered, then added in rank order: a reduction
  in the backend's own order would give another rounding than `LocalRing`).
* `LocalRing(n)` is n ranks in one process: `run(fn)` calls `fn` on n
  threads at once, one per rank, with the rank held in a thread-local.
  Tensors pass by reference through one slot per rank between waits on a
  `threading.Barrier` with a timeout. All ranks run on the caller's CUDA
  stream, so the host order the barrier gives is also the device order.
  An exception in any rank aborts the barrier, every other rank stops at
  its next collective, and `run` re-raises the first error: a failing rank
  never leaves the others waiting.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def _sum_in_rank_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


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
        if self._barrier.broken:
            self._barrier.reset()
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
                self._barrier.abort()
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

    def rotate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.size == 1:
            return list(tensors)
        return list(self._exchange(list(tensors))[(self.rank - 1) % self.size])

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _sum_in_rank_order(self._exchange(t))

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._exchange(t)).amax(0)

    def all_gather_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._exchange(t), dim=dim)


class ProcessGroupRing:
    """One rank per process over a `torch.distributed` process group
    (`group=None`: the default one). Create the group with a finite
    timeout, as `init_process_group` below does, so a rank that dies leaves
    the others with an error and not a hang."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

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

    def _peer(self, rank: int) -> int:
        rank %= self.size
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def rotate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.size == 1:
            return list(tensors)
        outs = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, outs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self._peer(self.rank + 1),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, o, self._peer(self.rank - 1), self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _sum_in_rank_order(self._gather(t))

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def all_gather_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self._gather(t), dim=dim)
