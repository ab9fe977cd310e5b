"""Entry points: sampling, evaluation, inference, training, the offline
data path and the data factory.

The sampler's names are imported on first use: the data factory's
host-only stage workers import `prepare_dataset` through this package and
never touch torch, and importing torch takes seconds.
"""

__all__ = ["SamplerConfig", "decode_latents", "make_sampler"]


def __getattr__(name):
    if name in __all__:
        from orv_tpu_torch.pipelines import sample

        return getattr(sample, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
