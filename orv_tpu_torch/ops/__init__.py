from orv_tpu_torch.ops.adaln import gated_residual, modulate_norm
from orv_tpu_torch.ops.attention import flash_attention

__all__ = ["flash_attention", "gated_residual", "modulate_norm"]
