"""Device and dtype resolution shared by the port's entry points.

Every entry point (``transformer_lm``, ``Sequential``, ``FittedModel.load``,
``ModelPredictor``) takes ``device=None``, which means the CUDA card.  With
no card it raises: the port never drops quietly to the CPU.  Tests and
other CPU callers pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """A JAX-style dtype name (``"bfloat16"``) → the torch dtype."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


def host_to_device(a, device: torch.device,
                   non_blocking: bool = False) -> torch.Tensor:
    """A host array (or tensor) on ``device``; float64 becomes float32, as
    the JAX package (64-bit mode off) stores it.  With ``non_blocking`` a
    copy to a CUDA device goes from pinned memory and does not wait for
    the card; without it the host waits for the copy."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    if non_blocking and device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
