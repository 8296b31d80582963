"""Device policy of the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a host without
    CUDA: the port never falls back to the CPU on its own. Pass
    ``device="cpu"`` to run there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass device='cpu' "
                           "to run the port on the CPU")
    return dev
