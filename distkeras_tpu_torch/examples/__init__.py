"""The reference workloads' example scripts on the port, each run as
``python -m distkeras_tpu_torch.examples.<name>`` with the JAX script's
flags plus ``--device`` (``cuda`` by default; ``cpu`` runs them without a
card)."""

import torch


def default_workers(device: str) -> int:
    """The worker count when none is given: one worker a CUDA device (the
    JAX scripts take one a visible device), one on the CPU."""
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1
