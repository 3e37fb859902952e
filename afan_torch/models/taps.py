"""Tap points: a model as a static sequence of stages — the PyTorch
counterpart of ``afan/models/taps.py``.

Every reference trainer runs stages ``[0, k)`` to get the tapped feature
(the "head"), then stages ``[k, N)`` from a possibly adversarial feature
(the "tail"); `Classification/resnet_s.py:119-121` slices an
``nn.Sequential`` for it. A :class:`StagedModule` declares its ordered
stages; ``forward(x, start, end)``, :meth:`head`, :meth:`tail` and
:meth:`multi_head` run slices of them. Train and eval mode are the modules'
own, as usual in PyTorch.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn

Stage = Callable[[torch.Tensor], torch.Tensor]


class StagedModule(nn.Module):
    """Base class for models exposing head/tail split forwards. Subclasses
    return their ordered stages from :meth:`stages`."""

    def stages(self) -> Sequence[Stage]:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def num_stages(self) -> int:
        return len(self.stages())

    def forward(self, x: torch.Tensor, start: int = 0,
                end: Optional[int] = None) -> torch.Tensor:
        """Run stages ``[start, end)`` — the reference's
        ``forward(x, end_point, start_point)``."""
        stage_list = self.stages()
        if end is None:
            end = len(stage_list)
        for i in range(start, end):
            x = stage_list[i](x)
        return x

    def head(self, x: torch.Tensor, tap: int) -> torch.Tensor:
        """Input → tapped feature (stages ``[0, tap)``)."""
        return self(x, 0, tap)

    def tail(self, feature: torch.Tensor, tap: int) -> torch.Tensor:
        """(Possibly adversarial) tapped feature → output (stages
        ``[tap, N)``)."""
        return self(feature, tap, None)

    def multi_head(self, x: torch.Tensor, taps: Sequence[int]
                   ) -> List[torch.Tensor]:
        """One forward collecting the features at several taps: stages
        ``[0, max(taps))`` run once. Equal to ``[self.head(x, t) for t in
        taps]``; features come back in ``taps`` order (duplicates
        allowed)."""
        stage_list = self.stages()
        taps = tuple(int(t) for t in taps)
        if not taps:
            raise ValueError("multi_head requires at least one tap point")
        for t in taps:
            check_tap(t, len(stage_list))
        tap_set = set(taps)
        last = max(taps)
        feats = {}
        for i in range(last):
            if i in tap_set:
                feats[i] = x
            x = stage_list[i](x)
        feats[last] = x
        return [feats[t] for t in taps]


def check_tap(tap: int, num_stages: int) -> None:
    if not (0 <= tap <= num_stages):
        raise ValueError(f"tap point {tap} out of range [0, {num_stages}]")
