"""What the detection cells share: the static canvas, the seeded state of
a Faster R-CNN (layer4's alias ``detection.hidden`` tied to it) and the
fit of its torso's frozen BatchNorms to a batch of the cell's own images,
the rule of ``chip_smoke.calibrated_backbone`` run on the reference's
torso (``reference/det/resnet.py``), in memory."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import weights
from ..reference.det import resnet

FEATURES = "features."
HIDDEN = "detection.hidden."
LAYER4 = "features.layer4."


def canvas_hw(cfg: Dict) -> Tuple[int, int]:
    """The static canvas: each side of the resize rule rounded up to 16."""
    return (int(math.ceil(cfg["image_min_side"] / 16) * 16),
            int(math.ceil(cfg["image_max_side"] / 16) * 16))


def _tie_hidden(state: Dict) -> Dict:
    for key in list(state):
        if key.startswith(HIDDEN):
            state[key] = state[LAYER4 + key[len(HIDDEN):]]
    return state


def seeded_state(shapes, seed: int, device) -> Dict:
    return _tie_hidden(weights.seeded_state(shapes, seed, device))


def calibrated(backbone: str, state: Dict, images: torch.Tensor,
               device) -> Dict:
    """``state`` with each frozen BatchNorm of the torso set to its input's
    per-channel mean and (biased) variance on ``images`` (NHWC), in one
    float32 forward of the reference's torso in which each is set before
    it runs."""
    with torch.device(device):
        torso = resnet.from_name(backbone)
    torso.load_state_dict({k[len(FEATURES):]: v for k, v in state.items()
                           if k.startswith(FEATURES)})

    def fit(bn, inputs):
        var, mean = torch.var_mean(inputs[0].float(), dim=(0, 2, 3),
                                   correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(fit) for m in torso.modules()
             if isinstance(m, resnet.FrozenBatchNorm)]
    try:
        with torch.no_grad():
            torso(images.permute(0, 3, 1, 2).to(device), 0, 4)
    finally:
        for h in hooks:
            h.remove()
    out = dict(state)
    out.update({FEATURES + k: v.detach().clone()
                for k, v in torso.state_dict().items()})
    return _tie_hidden(out)
