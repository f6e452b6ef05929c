"""Device resolution shared by the port's entry points.

The port runs on a CUDA card.  An entry point given ``device=None`` takes
the current CUDA device; on a host without one it raises rather than
quietly running on the CPU, so a missing card never shows up later as a
mysteriously slow run.  Callers that want the CPU (the tests, a laptop)
ask for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   what: str = "this entry point") -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the current
    CUDA device and raises :class:`RuntimeError` when CUDA is absent."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
