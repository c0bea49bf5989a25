"""Model zoo of the port (counterpart of ``distkeras_tpu.models``)."""

from .zoo import transformer_lm

__all__ = ["transformer_lm"]
