"""Data layer of the port (counterpart of ``distkeras_tpu.data``): the
column store, the transformer pipeline, the workload datasets and the
streaming input path of the distributed engine, and sequence packing."""

from .dataset import Dataset
from .datasets import (has_real_data, load_atlas_higgs, load_cifar10,
                       load_digits, load_mnist, read_csv)
from .packing import pack_documents, packed_lm_labels, packing_efficiency
from .pipeline import prefetch_to_device, round_stream
from .transformers import (DenseTransformer, LabelIndexTransformer,
                           LabelVectorTransformerUDF, MinMaxTransformer,
                           OneHotTransformer, ReshapeTransformer,
                           StandardScaleTransformer, Transformer)

__all__ = [
    "Dataset", "Transformer", "MinMaxTransformer", "StandardScaleTransformer",
    "DenseTransformer", "ReshapeTransformer", "OneHotTransformer",
    "LabelIndexTransformer", "LabelVectorTransformerUDF",
    "load_mnist", "load_cifar10", "load_atlas_higgs", "load_digits",
    "has_real_data", "read_csv", "round_stream", "prefetch_to_device",
    "pack_documents", "packed_lm_labels", "packing_efficiency",
]
