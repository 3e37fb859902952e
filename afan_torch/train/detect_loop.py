"""Detection steps — the PyTorch counterpart of
``afan/train/detect_loop.py``. This slice ports the eval forward only; the
training steps come with the training path."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models.frcnn.model import FasterRCNN


def make_detect_fn(model: FasterRCNN
                   ) -> Callable[[torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]]:
    """Eval forward → (boxes, probs, keep) on the model's device, under
    ``torch.inference_mode``. Images (B, H, W, 3) in [0, 1] may come from
    the host; they are copied to the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def detect(images: torch.Tensor):
        return model.detect(images.to(device, torch.float32))

    return detect
