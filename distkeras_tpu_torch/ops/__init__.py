"""Tensor ops of the port (counterpart of ``distkeras_tpu.ops``)."""

from .attention import attention, dot_product_attention, validate_window
from .flash_attention import flash_attention, flash_attention_reference
from .fused_ce import fused_softmax_cross_entropy
from .rope import (apply_rope, ntk_theta, rope_angles, validate_rope_dim,
                   validate_rope_scaling)

__all__ = ["attention", "dot_product_attention", "validate_window",
           "flash_attention", "flash_attention_reference",
           "fused_softmax_cross_entropy", "apply_rope",
           "ntk_theta", "rope_angles", "validate_rope_dim",
           "validate_rope_scaling"]
