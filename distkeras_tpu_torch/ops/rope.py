"""Rotary position embeddings (RoPE), port of ``distkeras_tpu/ops/rope.py``.

Each (even, odd) channel pair of q and k is rotated by an angle
proportional to the token's absolute position, so q·k depends only on the
relative distance.  Rotation happens at projection time, before the
attention dispatch, so it composes with every attention impl.

Arithmetic is f32, output in the input dtype.  Only the scalar-position
form ``positions: (S,)`` is ported; the per-row ``(B, S)`` form arrives
with decode.
"""

from __future__ import annotations

import torch


def validate_rope_dim(dim: int) -> int:
    """Channel pairs need an even head dim."""
    if int(dim) % 2:
        raise ValueError(f"RoPE needs an even head dim, got {dim}")
    return int(dim)


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0,
                scale: float = 1.0) -> torch.Tensor:
    """(S,) integer positions → (S, dim/2) f32 rotation angles.

    ``scale`` > 1 is linear position interpolation (positions divided by
    ``scale``); for the NTK-aware variant raise ``theta`` via
    :func:`ntk_theta` instead."""
    validate_rope_dim(dim)
    exps = -torch.arange(0, dim, 2, dtype=torch.float32,
                         device=positions.device) / dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    pos = positions.to(torch.float32) / scale
    return pos[:, None] * freqs[None, :]


def ntk_theta(factor: float, dim: int, theta: float = 10000.0) -> float:
    """NTK-aware context extension: ``theta · factor^(dim / (dim - 2))``."""
    validate_rope_dim(dim)
    if dim <= 2:
        raise ValueError(f"ntk_theta needs head dim > 2 (the exponent is "
                         f"dim/(dim-2)), got {dim}")
    if factor < 1.0:
        raise ValueError(f"extension factor must be >= 1, got {factor}")
    return float(theta * factor ** (dim / (dim - 2)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scale: float = 1.0) -> torch.Tensor:
    """Rotate (B, S, H, D) q or k by the angles of (S,) ``positions``."""
    if positions.ndim != 1:
        raise NotImplementedError(
            "apply_rope: only (S,) positions are ported; the per-row (B, S) "
            "form arrives with decode")
    b, s, h, d = x.shape
    ang = rope_angles(positions, d, theta, scale)       # (S, d/2)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin,
                       x1 * sin + x2 * cos], dim=-1).reshape(b, s, h, d)
    return out.to(x.dtype)


def validate_rope_scaling(theta: float, scale: float):
    """The single rope_theta/rope_scale rule."""
    if theta <= 0.0:
        raise ValueError(f"rope_theta must be > 0, got {theta}")
    if scale < 1.0:
        raise ValueError(f"rope_scale must be >= 1, got {scale}")
    return float(theta), float(scale)
