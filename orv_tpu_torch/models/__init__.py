from orv_tpu_torch.models.dit import ControlDiT, DiTConfig
from orv_tpu_torch.models.vae import (CausalVAE, VAEConfig, decode_chunked, encode_auto,
                                     encode_chunked, tiled_decode)

__all__ = ["CausalVAE", "ControlDiT", "DiTConfig", "VAEConfig", "decode_chunked", "encode_auto",
           "encode_chunked", "tiled_decode"]
