"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for (or
    defaulted to) and none is available: the port never falls back to the
    CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "afan_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
