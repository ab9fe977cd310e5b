"""The grain loader's batches, computed without grain (`train.loader: grain`).

Counterpart of `orv_tpu/data/grain_loader.py`, which builds a
`grain.DataLoader` over a `grain.IndexSampler` (sharded by JAX process,
shuffled from a seed, epochs chained end to end) and a `grain.Batch`
operation. The order in which grain reads records is a pure function of
(record count, seed, epoch), so this module computes it and reads the same
records in the same order, batch for batch:

  * `index_shuffle` repeats grain's compiled `grain::random::index_shuffle`:
    a Feistel cipher on a block of at least 16 bits, keyed by
    `std::seed_seq{seed}`, cycle-walked into [0, max_index];
  * `record_order` is `IndexSampler`'s order: position j reads record
    `index_shuffle(j % n, n - 1, seed + j // n)`;
  * `make_grain_loader` groups consecutive records into batches (a batch
    may straddle two epochs, as grain's `Batch` does), stacks them as
    grain's batch function does (`np.stack` per leaf, dict keys sorted)
    and renames the keys as the JAX module's `_normalize` does.

The JAX loader shards by JAX process; it runs in one process, and the port
in one host whose rank 0 reads for the whole mesh, so both read shard 0 of
1: the whole dataset. (Grain's shard s of c is the one-shard order over
n // c records, offset by s * (n // c).)

`worker_count > 0` reads the records in that many spawned processes (a
forked child cannot use a card its parent initialised). The batches come
out in the sampler's order whatever the workers' timing, so the worker
count changes no batch. The workers import neither torch nor the parent's
main module (multiprocessing would re-run it in each: the training entry
point's imports take seconds), unless the dataset's class lives there.
`IndexSampler` also gives each record a Philox generator; it feeds only
random map operations, and neither loader has one, so none is made here.

A dataset that fails on a record resamples another one from the global
`random` module (`RobotDataset.__getitem__`). In workers those draws come
from each worker's own `random`, so they differ from the in-process ones,
as they do between the JAX package's in-process and worker grain loaders.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import multiprocessing as mp
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from orv_tpu_torch.utils.logging import CONSOLE

_M32 = 0xFFFFFFFF


def _seed_seq(seed: int, n: int) -> List[int]:
    """`std::seed_seq{seed}.generate` into `n` 32-bit words (the C++
    standard's [rand.util.seedseq] algorithm)."""
    v = [seed & _M32]
    s = len(v)
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)
    mix = lambda x: x ^ (x >> 27)
    for k in range(m):
        r1 = 1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n]) & _M32
        r2 = r1 + (s if k == 0 else k % n + v[k - 1] if k <= s else k % n) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = 1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _cipher(max_index: int, seed: int):
    """(half width W, the 4 round keys mod 2^W) of grain's cipher for
    `max_index`. The block is max(16, c + c % 2) bits for c =
    ceil(log2(max_index)) in double precision: at max_index = 2^k it holds k
    bits, one short of max_index itself (grain's quirk, kept)."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    c = math.ceil(math.log2(float(max_index)))
    w = max(16, c + c % 2) // 2
    return w, [np.uint64(k & ((1 << w) - 1)) for k in _seed_seq(seed, 4)]


def _encrypt(v: np.ndarray, w: int, keys) -> np.ndarray:
    """The Feistel rounds on the uint64 array `v`, W bits a half:
    f(z) = (rotl(z, 1) & rotl(z, 8)) ^ rotl(z, 2) on W bits."""
    mask, w_ = np.uint64((1 << w) - 1), np.uint64(w)
    rot = lambda z, r: ((z << np.uint64(r)) | (z >> np.uint64(w - r))) & mask
    f = lambda z: (rot(z, 1) & rot(z, 8 % w)) ^ rot(z, 2)
    x, y = (v >> w_) & mask, v & mask
    for i in range(0, len(keys), 2):
        x = x ^ f(y) ^ keys[i]
        y = y ^ f(x) ^ keys[i + 1]
    return (x << w_) | y


def _shuffle(v: np.ndarray, max_index: int, seed: int) -> np.ndarray:
    """`index_shuffle` of each of the uint64 array `v`: encrypt, and encrypt
    again where the result is above `max_index`."""
    if max_index == 0:
        return np.zeros(len(v), np.int64)
    w, keys = _cipher(max_index, seed)
    v = _encrypt(v, w, keys)  # first, since an index of 2^k overflows the block (the quirk)
    if w == 8:
        # grain's 16-bit minimum block, where a small range walks thousands
        # of steps: `jump[x]` starts as x's successor and doubles its stride
        # while it lands out of range, so it ends on x's first value in range
        jump = _encrypt(np.arange(1 << 16, dtype=np.uint64), w, keys)
        while (jump[v[v > max_index]] > max_index).any():
            jump = np.where(jump > max_index, jump[jump], jump)
        return np.where(v > max_index, jump[v], v).astype(np.int64)
    while (over := v > max_index).any():  # a wider block is under 4x the range: few steps
        v[over] = _encrypt(v[over], w, keys)
    return v.astype(np.int64)


def index_shuffle(index: int, max_index: int, seed: int) -> int:
    """The position of `index` in grain's permutation of [0, max_index]
    (`grain::random::index_shuffle`, 4 rounds)."""
    return int(_shuffle(np.array([index], np.uint64), max_index, seed)[0])


def shuffled_epoch(n: int, seed: int) -> np.ndarray:
    """`index_shuffle(k, n - 1, seed)` for every k < n, as one array."""
    return _shuffle(np.arange(n, dtype=np.uint64), n - 1, seed)


def record_order(num_records: int, seed: Optional[int] = 0, num_epochs: Optional[int] = None,
                 shuffle: bool = True) -> Iterator[int]:
    """The records `grain.IndexSampler` gives one shard, in order; endless
    when `num_epochs` is None. Refuses what the sampler refuses."""
    if num_records <= 0:
        raise ValueError(f"the sampler needs at least one record, got {num_records}")
    if num_epochs is not None and num_epochs <= 0:
        raise ValueError(f"num_epochs must be positive or None, got {num_epochs}")
    if shuffle and seed is None:
        raise ValueError("Shuffling requires specifying a seed.")
    if seed is not None and not 0 <= seed < 2**32:
        raise ValueError("Seed should be positive 32-bit integer.")
    return _order(num_records, seed, num_epochs, shuffle)


def _order(n: int, seed, num_epochs, shuffle: bool) -> Iterator[int]:
    for e in itertools.count() if num_epochs is None else range(num_epochs):
        yield from shuffled_epoch(n, (seed + e) % 2**32).tolist() if shuffle else range(n)


def _stack(items: List[Any]):
    """One batch of `items`, as grain's batch function makes it (a tree map
    of `np.stack` over the leaves, JAX's tree order: dict keys sorted)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in sorted(first)}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(leaves)) for leaves in zip(*items))
    if first is None:
        return None
    return np.stack(items)


def _normalize(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Align grain's stacked-batch naming with collate_control's output
    (metainfo -> metainfos, prompt -> prompts, num_views scalar)."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if k == "metainfo":
            out["metainfos"] = list(v) if not isinstance(v, dict) else _unstack_dicts(v)
        elif k == "prompt":
            out["prompts"] = list(v)
        elif k == "num_views":
            out[k] = int(np.asarray(v).reshape(-1)[0])
        else:
            out[k] = np.asarray(v)
    return out


def _unstack_dicts(d: Dict[str, Any]):
    """The per-sample scalar dicts collate_control emits, from a dict of [B] arrays."""
    arrs = {k: np.asarray(v) for k, v in d.items()}
    n = len(next(iter(arrs.values())))
    return [{k: (a[i].item() if a[i].ndim == 0 else a[i]) for k, a in arrs.items()}
            for i in range(n)]


# -- worker processes ---------------------------------------------------------------

_DATASET = None  # a worker's dataset


def _hold(dataset) -> None:
    global _DATASET
    _DATASET = dataset


def _read(idx: int):
    return _DATASET[idx]


@contextlib.contextmanager
def _without_main(dataset):
    """While open, spawned children do not re-run this process's main
    module (multiprocessing does so when `__main__` has a spec or a file),
    unless the dataset's class is defined there and they need it."""
    main = sys.modules["__main__"]
    if type(dataset).__module__ == "__main__":
        yield
        return
    spec, path = getattr(main, "__spec__", None), main.__dict__.pop("__file__", None)
    main.__spec__ = None
    try:
        yield
    finally:
        main.__spec__ = spec
        if path is not None:
            main.__file__ = path


def _read_in_workers(dataset, order: Iterator[int], worker_count: int,
                     ahead: int) -> Iterator[Any]:
    """The records of `order`, read in `worker_count` spawned processes with
    at most `ahead` in flight, yielded in order. A worker's error, or the
    pool's `BrokenProcessPool` when a worker dies, is raised with a note
    naming the record; closing stops the workers."""
    pool = ProcessPoolExecutor(worker_count, mp_context=mp.get_context("spawn"),
                               initializer=_hold, initargs=(dataset,))

    def submit(idx):
        with _without_main(dataset):  # the pool spawns its workers as tasks come
            return idx, pool.submit(_read, idx)

    try:
        pending = collections.deque(submit(idx) for idx in itertools.islice(order, ahead))
        pos = 0
        while pending:
            idx, fut = pending.popleft()
            try:
                item = fut.result()
                pending.extend(submit(i) for i in itertools.islice(order, 1))
            except Exception as e:
                e.add_note(f"raised by a grain loader worker reading record {idx} "
                           f"(position {pos})")
                raise
            yield item
            pos += 1
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


class GrainLoader:
    """Iterator of collated batches (`make_grain_loader`); `close()` stops
    its workers. `worker_start_s` is the seconds from starting the workers
    to the first record they read (None in-process, or before the first
    batch)."""

    def __init__(self, dataset, batch_size: int, order: Iterator[int], worker_count: int,
                 drop_remainder: bool):
        self.worker_start_s: Optional[float] = None
        self._batches = self._run(dataset, batch_size, order, worker_count, drop_remainder)

    def _run(self, dataset, batch_size, order, worker_count, drop_remainder):
        if worker_count > 0:
            t0 = time.perf_counter()
            records = _read_in_workers(dataset, order, worker_count,
                                       ahead=2 * batch_size * worker_count)
        else:
            records = (dataset[idx] for idx in order)
        with contextlib.closing(records):
            buf = []
            for item in records:
                if worker_count > 0 and self.worker_start_s is None:
                    self.worker_start_s = time.perf_counter() - t0
                    CONSOLE.log(f"grain loader: {worker_count} workers read their first "
                                f"record in {self.worker_start_s:.2f} s")
                buf.append(item)
                if len(buf) == batch_size:
                    yield _normalize(_stack(buf))
                    buf = []
            if buf and not drop_remainder:
                yield _normalize(_stack(buf))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        return next(self._batches)

    def close(self) -> None:
        self._batches.close()


def make_grain_loader(dataset, batch_size: int, seed: int = 0, num_epochs: Optional[int] = None,
                      worker_count: int = 0, shuffle: bool = True,
                      drop_remainder: bool = True) -> GrainLoader:
    """-> iterator of collated batches, the JAX package's
    `make_grain_loader`'s batch for batch (same layout as prefetch_batches).

    `worker_count=0` reads in this process; >0 in that many spawned
    processes, with the same batches. `drop_remainder` drops only the last,
    short batch of a finite run. Refuses what `grain.IndexSampler` refuses
    (shuffling without a seed, a seed outside [0, 2^32), `num_epochs <= 0`)."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be a positive integer. Got {batch_size}.")
    order = record_order(len(dataset), seed, num_epochs, shuffle)
    return GrainLoader(dataset, batch_size, order, int(worker_count), drop_remainder)
