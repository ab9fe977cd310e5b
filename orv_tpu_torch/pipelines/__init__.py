from orv_tpu_torch.pipelines.sample import SamplerConfig, decode_latents, make_sampler

__all__ = ["SamplerConfig", "decode_latents", "make_sampler"]
