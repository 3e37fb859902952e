"""Seeded weights, made on the device in a few large calls and handed
alike to the program and to the reference.

Every convolution kernel is drawn from one normal draw of all kernels
together and scaled leaf by leaf: kaiming-normal (gain 2) over the fan-out
in the backbone (``backbone.`` and, for detection, ``features.``), over the
fan-in elsewhere; biases are zero, BatchNorm scales one and shifts zero,
running means zero and variances one; a linear layer's weight takes
normal(0, 0.01). The draw depends on the seed, the keys and the shapes
alone.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

FAN_OUT_PREFIXES = ("backbone.", "features.")


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return "one"
    if leaf in ("running_mean", "num_batches_tracked", "bias"):
        return "zero"
    if len(shape) == 4:
        return "conv"
    if len(shape) == 2:
        return "linear"
    return "one" if leaf == "weight" else "zero"


def seeded_state(shapes: Iterable[Tuple[str, Tuple[int, ...], torch.dtype]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict over ``shapes`` ((key, shape, dtype) in order) from
    ``seed``, on ``device``."""
    shapes = list(shapes)
    draws = [(n, s) for n, s, _ in shapes if _kind(n, s) in ("conv",
                                                             "linear")]
    total = sum(math.prod(s) for _, s in draws)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, dtype in shapes:
        kind = _kind(name, shape)
        if kind in ("conv", "linear"):
            n = math.prod(shape)
            if kind == "conv":
                fan = (shape[0] * shape[2] * shape[3]
                       if name.startswith(FAN_OUT_PREFIXES)
                       else shape[1] * shape[2] * shape[3])
                std = math.sqrt(2.0 / fan)
            else:
                std = 0.01
            out[name] = (flat[at:at + n] * std).reshape(shape).to(dtype)
            at += n
        elif kind == "one":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def state_shapes(module: torch.nn.Module):
    """(key, shape, dtype) of every entry of ``module``'s state dict."""
    return [(k, tuple(v.shape), v.dtype)
            for k, v in module.state_dict().items()]
