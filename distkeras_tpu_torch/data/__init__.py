"""Data layer of the port (counterpart of ``distkeras_tpu.data``)."""

from .dataset import Dataset

__all__ = ["Dataset"]
