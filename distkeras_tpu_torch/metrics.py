"""Structured metrics, profiler tracing and analytic FLOPs, port of
``distkeras_tpu/metrics.py``.

Metrics are JSONL events with throughput derived per epoch;
:func:`trace` wraps ``torch.profiler`` (a TensorBoard-readable trace of
the card and the host) and :func:`annotate` names a region in it;
:func:`flops_per_example` and :func:`peak_flops` give the model FLOP
utilization of the examples/sec/chip metric.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import IO, Any, Dict, List, Optional


class MetricsLogger:
    """Append-only JSONL event log + in-memory history.

    Events carry a wall-clock ``t`` and arbitrary scalar fields:
    ``log(step=3, loss=0.7, examples_per_sec=1e6)``.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[Dict[str, Any]] = []
        self._fh: Optional[IO[str]] = open(path, "a") if path else None

    def log(self, **fields) -> Dict[str, Any]:
        # absolute wall time: stays monotonic when a resumed run appends to
        # the same JSONL file
        event = {"t": round(time.time(), 6)}
        event.update({k: (float(v) if hasattr(v, "item") else v)
                      for k, v in fields.items()})
        self.events.append(event)
        if self._fh:
            self._fh.write(json.dumps(event) + "\n")
            self._fh.flush()
        return event

    def scalar_series(self, field: str) -> List[float]:
        return [e[field] for e in self.events if field in e]

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


class EpochMetrics:
    """Per-epoch throughput for the trainers: examples/sec and
    examples/sec/chip from (rows, seconds, num_chips)."""

    def __init__(self, logger: Optional[MetricsLogger] = None,
                 num_chips: int = 1):
        self.logger = logger or MetricsLogger()
        self.num_chips = max(int(num_chips), 1)

    def epoch(self, epoch: int, examples: int, seconds: float,
              mean_loss: float) -> Dict[str, Any]:
        eps = examples / seconds if seconds > 0 else float("inf")
        return self.logger.log(
            kind="epoch", epoch=epoch, examples=examples,
            seconds=round(seconds, 6), loss=mean_loss,
            examples_per_sec=round(eps, 2),
            examples_per_sec_per_chip=round(eps / self.num_chips, 2))


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the enclosed block (the host,
    and the card when there is one) into ``log_dir``, readable by
    TensorBoard and Perfetto.  No-ops when disabled."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline
    (``torch.profiler.record_function``)."""
    from torch.profiler import record_function
    with record_function(name):
        yield


# -- analytic FLOPs + MFU ----------------------------------------------------

# bf16 dense peak FLOP/s per card by device name substring, from NVIDIA's
# H100 Tensor Core GPU datasheet: half its bf16 figure "with sparsity"
# (PCIe 1,513 TFLOPS, NVL 1,671; SXM 1,979, kept at the 989 TFLOPS dense
# figure NVIDIA quotes); first match wins, and no key is a substring of
# another part's name.  "H100 80GB HBM3" is the SXM part's name as
# torch.cuda.get_device_name() gives it
_PEAK_FLOPS = (
    ("H100 PCIe", 756.5e12),
    ("H100 NVL", 835.5e12),
    ("H100 80GB HBM3", 989e12),
    ("H100 SXM", 989e12),
)


def peak_flops(device_kind: str) -> Optional[float]:
    """bf16 peak FLOP/s for a ``torch.cuda.get_device_name()`` string, or
    None when unknown (the CPU, other cards): callers emit mfu=null
    then."""
    for key, val in _PEAK_FLOPS:
        if key.lower() in str(device_kind).lower():
            return val
    return None


def _attention_flops(layer, in_shape) -> float:
    """Matmul FLOPs of one attention layer on one example.

    Sizes the k/v projections by ``num_kv_heads`` so GQA/MQA models are not
    overcounted (q/o stay full-width: ``num_heads * key_dim``), and caps the
    score/value matmuls at the sliding-window width when one is set.
    """
    s, d = in_shape
    inner = layer.num_heads * layer.key_dim
    kv_heads = layer.num_kv_heads or layer.num_heads
    inner_kv = kv_heads * layer.key_dim
    total = 2.0 * s * d * (inner + 2.0 * inner_kv)  # q + k + v projections
    total += 2.0 * s * inner * d                  # output projection
    window = getattr(layer, "attention_window", None)
    ctx = float(min(s, window + 1)) if window is not None else float(s)
    total += 2.0 * 2.0 * s * ctx * inner          # qk^T and scores@v
    return total


def flops_per_example(model, backward: bool = True) -> float:
    """Analytic matmul/conv FLOPs for one example through a ``Sequential``.

    Counts the tensor-core work only (Dense 2·m·k·n, Conv2D
    2·Ho·Wo·kh·kw·cin·cout, the attention and MLP projections inside
    TransformerBlock); elementwise and pooling FLOPs are negligible
    against these.  ``backward=True`` applies the standard 3x rule
    (forward + ~2x for the two backward matmuls per forward matmul) — the
    number MFU is judged against.  The layers' output shapes come from a
    copy of the model built on the ``meta`` device, so the model itself
    is left as it is.
    """
    import numpy as np
    import torch
    from .core import layers as L

    if model.input_shape is None:
        raise ValueError("model has no input_shape")
    shape = tuple(model.input_shape)
    generator = torch.Generator().manual_seed(0)
    meta = torch.device("meta")
    total = 0.0
    for layer in model.layers:
        layer = L.Layer.from_config(layer.get_config())
        out_shape = tuple(layer.build(shape, generator, meta))
        if isinstance(layer, L.Dense):
            rows = float(np.prod(shape[:-1])) if len(shape) > 1 else 1.0
            total += 2.0 * rows * shape[-1] * layer.units
        elif isinstance(layer, L.Conv2D):
            ho, wo, _ = out_shape
            kh, kw = layer.kernel_size
            total += 2.0 * ho * wo * kh * kw * shape[-1] * layer.filters
        elif isinstance(layer, L.Embedding):
            pass  # gather, not matmul
        elif isinstance(layer, L.MultiHeadAttention):
            total += _attention_flops(layer, shape)
        elif isinstance(layer, L.TransformerBlock):
            s, d = shape
            total += _attention_flops(layer, shape)
            total += 2.0 * s * d * layer.mlp_dim * 2  # mlp in+out
        shape = out_shape
    return total * (3.0 if backward else 1.0)
