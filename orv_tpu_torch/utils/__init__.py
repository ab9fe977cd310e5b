"""Device policy, embeddings, checkpoints, logging, tracking and video IO.

`resolve_device` is imported on first use: the logging module is imported
by processes that never touch torch (the data factory's host-only stage
workers), and importing torch takes seconds.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from orv_tpu_torch.utils.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
