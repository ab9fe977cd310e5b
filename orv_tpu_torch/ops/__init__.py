from orv_tpu_torch.ops.adaln import gated_residual, modulate_norm, modulate_norm_q8
from orv_tpu_torch.ops.attention import flash_attention, flash_attention_q8

__all__ = ["flash_attention", "flash_attention_q8", "gated_residual", "modulate_norm",
           "modulate_norm_q8"]
