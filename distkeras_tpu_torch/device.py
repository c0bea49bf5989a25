"""Device and dtype resolution shared by the port's entry points.

Every entry point (``transformer_lm``, ``Sequential``, ``FittedModel.load``,
``ModelPredictor``) takes ``device=None``, which means the CUDA card.  With
no card it raises: the port never drops quietly to the CPU.  Tests and
other CPU callers pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

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
