"""The port's default device: the CUDA card, unless the caller names one."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``.

    ``None`` means the CUDA card.  Without one it raises: the port never
    falls back to the CPU on its own; a caller that wants the CPU (the
    tests) passes ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: uzliti_slam_tpu_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")
