"""Where the port's entry points allocate: the card unless the caller says otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``, which must exist.

    Entry points never fall back to the CPU on their own: a caller that
    wants the CPU passes ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
