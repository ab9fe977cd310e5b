"""Console logging.

Counterpart of `orv_tpu/utils/logging.py`: one global `CONSOLE` with a rich
`Console(width=120)` where rich is installed, else a plain shim with the
same `.log` / `.print` / `.rule` surface.
"""

import sys
import time


class _PlainConsole:
    def log(self, *args, **kwargs):
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}]", *args, file=sys.stderr)

    def print(self, *args, **kwargs):
        print(*args)

    def rule(self, title: str = ""):
        print("-" * 40, title, "-" * 40)


try:
    from rich.console import Console

    CONSOLE = Console(width=120)
except Exception:  # pragma: no cover - rich is optional
    CONSOLE = _PlainConsole()


def log(*args, **kwargs):
    CONSOLE.log(*args, **kwargs)
