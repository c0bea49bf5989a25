"""Tensor ops of the port (counterpart of ``distkeras_tpu.ops``)."""

from .attention import attention, dot_product_attention, validate_window
from .flash_attention import flash_attention, flash_attention_reference
from .rope import (apply_rope, ntk_theta, rope_angles, validate_rope_dim,
                   validate_rope_scaling)

__all__ = ["attention", "dot_product_attention", "validate_window",
           "flash_attention", "flash_attention_reference", "apply_rope",
           "ntk_theta", "rope_angles", "validate_rope_dim",
           "validate_rope_scaling"]
