"""Fused softmax cross-entropy: the CUDA kernels' wrappers, their plain
versions, and the ``torch.autograd.Function`` that joins them.

Port of ``distkeras_tpu/ops/fused_ce.py :: fused_softmax_cross_entropy``,
the ``jax.custom_vjp`` over two Pallas kernels, now
``csrc/fused_ce.cu`` (CUDA C++ for Hopper, ``sm_90a``, built by ``nvcc``
at first use and bound with ``ctypes``; the source's header says what
bounds it on the H100 and what its design does about it):

- ``_fwd_kernel`` (:func:`fused_ce_fwd`): per-token ``loss = lse -
  logits[label]`` and the (T,) f32 lse in one streaming pass per row;
- ``_bwd_kernel`` (:func:`fused_ce_bwd`): ``dlogits = ct · (exp(logits -
  lse) - onehot(label))`` in the logits dtype.

Contract (the JAX kernels'): logits (T, V) in f32, bf16 or f16; labels
(T,) converted to int32 (as the JAX call does); arithmetic in f32 with the
online recurrence's guards (``safe_m = 0`` where the row max is -inf,
``l == 0`` taken as 1); a label outside [0, V) picks nothing and marks no
column (the one-hot sum of the TPU kernel: ``loss = lse``, never a fault).
No (T, V) tensor beyond the gradient itself is ever written.

Each wrapper launches its kernel for CUDA tensors, counting one launch in
its ``launches`` attribute, or raises (a dtype other than f32/bf16/f16,
bad shapes, operands on another device, non-contiguous logits, a failed
build or launch); it runs its plain version only for CPU tensors.  The
public :func:`fused_softmax_cross_entropy` first copies CUDA logits that
are a non-contiguous or misaligned view into a fresh tensor
(``kernels.kernel_operand``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ..kernels import count_launch, kernel_operand

#: the dtypes the kernels take (codes of the C calls)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the C interface takes int sizes
_MAX_DIM = 2 ** 31 - 64

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
#: each C entry point of csrc/fused_ce.cu: its number of pointers
_ENTRIES = {"fused_ce_fwd": 4, "fused_ce_bwd": 5}
_fns = {}  # entry name -> bound C function, loaded at first launch
#: held while an entry is bound, so two threads' first launches bind once
_fns_lock = threading.Lock()


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        with _fns_lock:
            fn = _fns.get(name)
            if fn is None:
                from ..kernels import load
                fn = getattr(load("fused_ce"), name)
                # pointers, then T, V, dtype, stream
                fn.argtypes = [_PTR] * _ENTRIES[name] + [_INT] * 3 + [_PTR]
                fn.restype = _INT
                _fns[name] = fn
    return fn


def _launch(name: str, ptrs, logits: torch.Tensor) -> None:
    t, v = logits.shape
    with torch.cuda.device(logits.device):  # launch on the tensors' card
        rc = _entry(name)(
            *ptrs, t, v, KERNEL_DTYPES[logits.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def as_labels(labels: torch.Tensor) -> torch.Tensor:
    """Labels as the kernels take them: contiguous int32 (the JAX call's
    ``astype(jnp.int32)``)."""
    return labels.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# plain versions (f32; f64 for f64 logits)
# ---------------------------------------------------------------------------

def fused_ce_forward_reference(logits: torch.Tensor, labels: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: (loss, lse), both
    (T,) f32.  The row's max with the ``safe`` guard, sum of exp, ``l == 0
    → 1``; the label's logit where ``0 <= label < V``, else 0."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    s = logits.to(acc)
    m = s.amax(dim=-1)
    safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    l = torch.exp(s - safe[:, None]).sum(dim=-1)
    lse = safe + torch.log(torch.where(l == 0.0, torch.ones_like(l), l))
    v = s.shape[1]
    lab = labels.long()
    hit = (lab >= 0) & (lab < v)
    got = s.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    return lse - torch.where(hit, got, torch.zeros_like(got)), lse


def fused_ce_backward_reference(logits: torch.Tensor, labels: torch.Tensor,
                                lse: torch.Tensor, ct: torch.Tensor
                                ) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: ``ct · (exp(s -
    lse) - onehot(label))`` in f32, cast to the logits dtype."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    s = logits.to(acc)
    cols = torch.arange(s.shape[1], device=s.device)
    hit = (cols[None, :] == labels.long()[:, None]).to(acc)
    p = torch.exp(s - lse.to(acc)[:, None])
    return (ct.to(acc)[:, None] * (p - hit)).to(logits.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def fused_ce_fwd(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (``_fwd_kernel``): (loss, lse), (T,) f32 each.
    A CUDA tensor launches it and counts one launch in
    ``fused_ce_fwd.launches``; a CPU tensor runs the plain version."""
    labels = as_labels(labels)
    if logits.device.type == "cpu":
        return fused_ce_forward_reference(logits, labels)
    _check(logits, labels)
    t = logits.shape[0]
    loss = torch.empty(t, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    _launch("fused_ce_fwd", (logits.data_ptr(), labels.data_ptr(),
                             loss.data_ptr(), lse.data_ptr()), logits)
    count_launch(fused_ce_fwd)
    return loss, lse


fused_ce_fwd.launches = 0


def fused_ce_bwd(logits: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The backward kernel (``_bwd_kernel``): dlogits in the logits dtype
    from the forward's lse and the per-row f32 cotangent ``ct``.  A CUDA
    tensor launches it and counts one launch in ``fused_ce_bwd.launches``;
    a CPU tensor runs the plain version."""
    labels = as_labels(labels)
    if logits.device.type == "cpu":
        return fused_ce_backward_reference(logits, labels, lse, ct)
    _check(logits, labels)
    for name, vec in (("lse", lse), ("ct", ct)):
        if (tuple(vec.shape) != (logits.shape[0],)
                or vec.dtype != torch.float32 or vec.device != logits.device
                or not vec.is_contiguous()):
            raise ValueError(
                f"fused_ce backward wants a contiguous (T,) f32 {name} on "
                f"{logits.device}; got {tuple(vec.shape)}, {vec.dtype}, "
                f"{vec.device}")
    dlogits = torch.empty_like(logits)
    _launch("fused_ce_bwd", (logits.data_ptr(), labels.data_ptr(),
                             lse.data_ptr(), ct.data_ptr(),
                             dlogits.data_ptr()), logits)
    count_launch(fused_ce_bwd)
    return dlogits


fused_ce_bwd.launches = 0


class FusedCrossEntropyFunction(torch.autograd.Function):
    """The counterpart of the ``jax.custom_vjp``: the forward saves
    (logits, labels, lse), never a (T, V) tensor of its own, and the
    backward runs the backward kernel with ``ct = g.float()`` (the plain
    versions for CPU tensors).  Labels get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = fused_ce_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return fused_ce_bwd(logits, labels, lse,
                            g.to(torch.float32).contiguous()), None


def fused_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                block_t: int = 256,
                                block_v: int = 512) -> torch.Tensor:
    """Per-token ``-log_softmax(logits)[label]`` without a (T, V)
    log-probability tensor: (T,) f32 losses; sums and means are the
    caller's.  Differentiable with respect to ``logits`` (the gradient
    comes in the logits dtype).  ``block_t`` and ``block_v`` are the TPU
    kernels' tile sizes, accepted so that calls written for the JAX
    function run unchanged; they change no result.  The JAX function's
    ``interpret`` has no counterpart.  CUDA logits that are a
    non-contiguous or misaligned view are first copied into a fresh tensor
    (the gradient comes back in the view's shape and strides)."""
    logits = kernel_operand(logits)
    labels = as_labels(labels)
    if torch.is_grad_enabled() and logits.requires_grad:
        return FusedCrossEntropyFunction.apply(logits, labels)
    return fused_ce_fwd(logits, labels)[0]


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    """Refuse what the kernels do not take, before any pointer is passed."""
    if not logits.is_cuda:
        raise ValueError("fused_ce kernel wants CUDA logits")
    if logits.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_ce kernel takes logits in one of "
                        f"{list(KERNEL_DTYPES)}, got {logits.dtype}")
    if logits.ndim != 2 or not (1 <= logits.shape[0] <= _MAX_DIM
                                and 1 <= logits.shape[1] <= _MAX_DIM):
        raise ValueError(f"fused_ce kernel wants (T, V) logits with "
                         f"1 <= T, V <= {_MAX_DIM}; got "
                         f"{tuple(logits.shape)}")
    if tuple(labels.shape) != (logits.shape[0],):
        raise ValueError(f"fused_ce wants (T,) labels for logits "
                         f"{tuple(logits.shape)}; got {tuple(labels.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"fused_ce: labels on {labels.device}, logits on "
                         f"{logits.device}")
    if not logits.is_contiguous():
        raise ValueError("fused_ce kernel needs contiguous logits")
