"""SAT spectrum sampling — the PyTorch counterpart of
``afan/core/spectrum.py``: ``number`` evenly spaced lerp points from the
clean to the adversarial feature, stacked on a new leading axis."""
from __future__ import annotations

import torch


def spectrum_weights(number: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """``[0, 1/(n-1), ..., (n-2)/(n-1), 1]``."""
    if number < 2:
        raise ValueError("spectrum needs at least 2 points (clean and adv)")
    percent = 1.0 / (number - 1)
    ws = [0.0] + [i * percent for i in range(1, number - 1)] + [1.0]
    return torch.tensor(ws, dtype=dtype, device=device)


def sample_points(clean: torch.Tensor, adv: torch.Tensor, number: int
                  ) -> torch.Tensor:
    """``(number, *clean.shape)`` with ``out[0] == clean``, ``out[-1] ==
    adv`` and ``out[i] == clean + w_i * (adv - clean)``."""
    ws = spectrum_weights(number, clean.dtype, clean.device)
    ws = ws.reshape((number,) + (1,) * clean.dim())
    return clean[None] + ws * (adv - clean)[None]
