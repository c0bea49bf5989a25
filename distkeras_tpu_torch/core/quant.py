"""Weight-only int8 quantization and the int8 KV cache, port of
``distkeras_tpu/core/quant.py``.

Decode reads every matmul kernel once per generated token, so storing the
kernels int8 with a per-output-channel f32 scale cuts that traffic 2x
against bf16 (4x against f32); activations, biases, norms and embedding
tables stay full precision.

In the port a quantized weight is a :class:`QuantizedTensor`: a sub-module
of the layer that held the weight, under the weight's own name, holding an
int8 buffer ``q`` and an f32 buffer ``scale``.  Every matmul site of
``core/layers.py`` and ``core/decode.py`` reads its weight through
:func:`read_weight`, the one accessor that dequantizes (f32 multiply, then
the cast to the compute dtype: the JAX ``QuantizedTensor.astype``
contract).  :func:`layers.layer_leaves` yields a quantized weight as its
two leaves ``q`` and ``scale``, in the JAX pytree's order.

Symmetric per-output-channel scheme: ``scale = max|w| / 127`` reduced over
all but the last axis, ``codes = round(w / scale)`` (half to even, as
``jnp.round``), computed in f32 as the JAX package does, so the codes are
the same bits.  Scales divide by a tensor of 127s, never by the Python
number: a CUDA division by a scalar multiplies by its rounded reciprocal,
which can land one ulp off the true quotient that the CPU (and XLA)
computes, so only the tensor division gives the card the CPU's scales bit
for bit.  Quantize after training (``FittedModel.quantize()``).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Set

import torch
from torch import nn

#: matmul-kernel names across Dense / Conv2D / MultiHeadAttention /
#: TransformerBlock; biases, norms and embedding tables are left out
QUANT_KEYS: Set[str] = {"kernel", "wq", "wk", "wv", "wo",
                        "mlp_w1", "mlp_w2"}


class QuantizedTensor(nn.Module):
    """(int8 codes, f32 per-output-channel scale) standing for a weight.
    ``shape``/``ndim`` are the logical weight's, ``dtype`` its logical
    (dequantized) dtype, and :meth:`astype` dequantizes."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32

    def astype(self, dtype: torch.dtype) -> torch.Tensor:
        """The dequantized weight in ``dtype``: f32 multiply, then the
        cast."""
        return (self.q.to(torch.float32) * self.scale).to(dtype)

    def extra_repr(self) -> str:
        return f"shape={tuple(self.shape)}, int8"


def read_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """The one accessor of a matmul weight: ``w`` in ``dtype``, a
    :class:`QuantizedTensor` dequantized."""
    if isinstance(w, QuantizedTensor):
        return w.astype(dtype)
    return w.to(dtype)


def quantize_tensor(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-output-channel int8: scale over all but the last
    axis."""
    w = w.detach().to(torch.float32)
    dims = tuple(range(w.ndim - 1))
    amax = torch.amax(torch.abs(w), dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def _quantize_in_place(module: nn.Module, keys: Set[str]) -> None:
    for name in sorted(module._parameters):
        w = module._parameters[name]
        if name in keys and w is not None and w.ndim >= 2:
            delattr(module, name)
            setattr(module, name, quantize_tensor(w))
    for child in module.children():
        if not isinstance(child, QuantizedTensor):  # idempotent
            _quantize_in_place(child, keys)


def quantize_params(model: nn.Module, keys: Set[str] = QUANT_KEYS
                    ) -> nn.Module:
    """A copy of ``model`` with every >= 2-D matmul kernel (matched by
    name) replaced by a :class:`QuantizedTensor`; everything else is
    copied as it is, and ``model`` is left unchanged.  Already quantized
    weights stay as they are."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        _quantize_in_place(out, keys)
    return out


def _dequantize_in_place(module: nn.Module) -> None:
    for name, child in list(module._modules.items()):
        if isinstance(child, QuantizedTensor):
            delattr(module, name)
            setattr(module, name,
                    nn.Parameter(child.astype(torch.float32)))
        elif child is not None:
            _dequantize_in_place(child)


def dequantize_params(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every :class:`QuantizedTensor` back to a
    plain f32 parameter (to resume training from a quantized model,
    accepting the rounding)."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        _dequantize_in_place(out)
    return out


def _leaf_bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of the model's leaves (int8 codes + scales for quantized
    weights, itemsize-true for the rest)."""
    return _leaf_bytes(list(model.parameters()) + list(model.buffers()))


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QuantizedTensor) for m in model.modules())


def logical_numel(model: nn.Module) -> int:
    """Elements of the model's leaves, a quantized weight counted by its
    logical shape (not its codes + scale)."""
    total = 0
    for m in model.modules():
        if isinstance(m, QuantizedTensor):
            total += math.prod(m.shape)
            continue
        total += sum(t.numel() for t in (*m._parameters.values(),
                                         *m._buffers.values())
                     if t is not None)
    return total


# ---------------------------------------------------------------------------
# KV-cache quantization (int8 cache entries, one scale per entry)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """(…, head_dim) k/v entries → ``(int8 codes, f32 scales)`` with one
    symmetric scale per entry (amax over head_dim).  Zero entries (slots
    never written) keep scale 0 and dequantize to exact zeros."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.zeros_like(amax))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127,
                    127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Codes + per-entry scales back to ``dtype``: f32 multiply, then the
    cast."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _cache_leaves(caches: Any):
    for c in caches:
        if c is not None:
            yield from (c[k] for k in sorted(c))


def kv_cache_bytes(caches: Any) -> int:
    """Bytes of a KV cache (a list of per-layer dicts or None; codes +
    scales for int8 caches, itemsize-true otherwise)."""
    return _leaf_bytes(_cache_leaves(caches))


def kv_block_bytes(caches: Any, block_size: int) -> int:
    """Bytes that one ``block_size``-token block costs across all layers
    of a flat (A, ...) cache: ``kv_cache_bytes(arena) ==
    kv_block_bytes(arena, bs) × (A / bs)``."""
    return sum((t.numel() // t.shape[0]) * t.element_size()
               for t in _cache_leaves(caches)) * int(block_size)
