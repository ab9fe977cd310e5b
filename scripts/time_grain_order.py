"""Time one epoch of the grain order (`orv_tpu_torch.data.grain_loader`).

`shuffled_epoch(n, seed)` walks each index along grain's cipher until it
falls in [0, n). At grain's 16-bit minimum block (n up to 2^16) it jumps
along a table of the encrypted block, doubling the stride; above it, each
step encrypts. This script times an epoch that way and with every step
encrypting at a few dataset sizes, checks that the two agree, and prints
one line a size:

    python scripts/time_grain_order.py [--sizes 2 5 9 ...] [--repeats 3]

Host code only: no card, no torch.
"""

from __future__ import annotations

import argparse
import platform
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from orv_tpu_torch.data import grain_loader as gl  # noqa: E402


def walk_by_encryption(n: int, seed: int) -> np.ndarray:
    """The same epoch with every step an encryption (no lookup table)."""
    w, keys = gl._cipher(n - 1, seed)
    v = gl._encrypt(np.arange(n, dtype=np.uint64), w, keys)
    while (over := v > n - 1).any():
        v[over] = gl._encrypt(v[over], w, keys)
    return v.astype(np.int64)


def best_of(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[2, 5, 9, 100, 1000, 16384, 40000, 1 << 20])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    print(f"host: {platform.processor() or platform.machine()}, numpy {np.__version__}")
    for n in args.sizes:
        assert np.array_equal(gl.shuffled_epoch(n, args.seed),
                              walk_by_encryption(n, args.seed)), n
        t_epoch = best_of(lambda: gl.shuffled_epoch(n, args.seed), args.repeats)
        t_enc = best_of(lambda: walk_by_encryption(n, args.seed), args.repeats)
        w, _ = gl._cipher(n - 1, args.seed)
        print(f"records {n}: block 2^{2 * w}, epoch {t_epoch * 1e3:.3f} ms "
              f"({'doubled jumps' if w == 8 else 'encrypt steps'}), every step encrypting "
              f"{t_enc * 1e3:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
