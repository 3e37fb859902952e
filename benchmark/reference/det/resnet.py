"""ImageNet-style ResNet torso (18/50/101) with static tap points — the
PyTorch counterpart of ``afan/models/resnet.py``, for the detection stack
(frozen BatchNorm, output stride 32) and the segmentation stack (trainable
BatchNorm, output stride 8 or 16 by dilation, ``low_level`` after layer1).

Module names follow torchvision (``conv1``, ``bn1``, ``layerN.i.convK``,
``layerN.i.downsample.0/1``), so reference checkpoints load with
``load_state_dict``. Layout is NCHW. The ImageNet normalisation is embedded
at the input, and ``forward(x, start, end)`` runs layers (start, end]:
``start=0`` includes the stem; the detection features are (0, 3] and layer4
is the ROI head's "hidden" stage (:meth:`ResNetTorso.run_stage`).

Initialisation mirrors flax's: kaiming-normal (fan_out) conv kernels and
identity BatchNorm, drawn from an explicit ``torch.Generator``.

Compute dtype (``afan``'s ``dtype`` on every Flax module, bfloat16 under
``--bf16``), written out rather than left to ``torch.autocast``, whose op
lists differ between the CPU and the card: parameters and BatchNorm
buffers stay float32; each :class:`Conv2d` casts its input and its weight
to :func:`set_compute_dtype`'s dtype (gradients reach the float32
parameters through the cast), and so does each :class:`Linear` (Flax's
``Dense``); BatchNorm takes the statistics and the normalization in float32
and returns the input's dtype (Flax's ``force_float32_reductions``,
PyTorch's mixed-type ``batch_norm``); :class:`FrozenBatchNorm` on a
bfloat16 input computes Flax's ``(x - mean) * (rsqrt(var + eps) * scale) +
bias`` in float32 and rounds once. The ImageNet normalisation runs in the
image's float32, as in ``afan``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple, Type, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import parallel as mesh
from . import parallel as spatial
from .parallel import remat
from ..seg_model import fp8_round

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (at 2 std) with variance
    1/fan_in."""
    fan_in = t[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and checkpoint keys) that computes in
    ``compute_dtype``: float32 as ``nn.Conv2d``; otherwise the input, the
    weight and the bias are cast to it, and the bias is added after the
    convolution, as Flax's ``Conv`` adds it (``y + bias``, rounded
    twice)."""

    compute_dtype = torch.float32
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = spatial.active()
        if sh is not None:
            return self._row_sharded(sh, x)
        dt = self.compute_dtype
        if self.fp8:
            y = self._conv_forward(fp8_round(x.to(dt)),
                                   fp8_round(self.weight.to(dt)), None)
            return y if self.bias is None else y + self.bias.to(dt).reshape(
                1, -1, 1, 1)
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).reshape(1, -1, 1, 1)

    def _row_sharded(self, sh, x: torch.Tensor) -> torch.Tensor:
        """This rank's output rows of the convolution of a row-sharded
        ``x``: from the input window they read (zero rows outside the
        image), with no row padding."""
        k, stride = self.kernel_size[0], self.stride[0]
        pad, dil = self.padding[0], self.dilation[0]
        if k > 1 or stride > 1:
            n = sh.global_height(self, x.shape[2])
            _, windows = spatial.conv_windows(sh, n, k, stride, pad, dil)
            x = spatial.window_rows(x, n, windows, 0.0)
        dt = self.compute_dtype
        if x.shape[2] == 0:
            kw, sw, pw, dw = (self.kernel_size[1], self.stride[1],
                              self.padding[1], self.dilation[1])
            w_out = (x.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
            params = [p for p in (self.weight, self.bias) if p is not None]
            return spatial.no_rows(
                (x.shape[0], self.out_channels, 0, w_out), dt, x, *params)
        pads = (0, self.padding[1])
        if dt == torch.float32:
            return F.conv2d(x, self.weight, self.bias, self.stride, pads,
                            self.dilation, self.groups)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, pads,
                     self.dilation, self.groups)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).reshape(1, -1, 1, 1)


class Linear(nn.Linear):
    """``nn.Linear`` (same parameters and checkpoint keys) that computes in
    ``compute_dtype``, as Flax's ``Dense(dtype=...)``: the input, the
    weight and the bias are cast to it and the bias is added after the
    product (rounded twice)."""

    compute_dtype = torch.float32
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.fp8:
            y = F.linear(fp8_round(x.to(dt)), fp8_round(self.weight.to(dt)))
            return y if self.bias is None else y + self.bias.to(dt)
        if dt == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Make every :class:`Conv2d` and :class:`Linear` of ``module`` compute
    in ``dtype``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = dtype


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm that always normalizes with its running statistics and
    never updates them (eps 1e-5), in train and eval mode alike. It keeps
    ``nn.BatchNorm2d``'s parameters and buffers, so checkpoint keys match.

    A float32 input goes through ``batch_norm``. Any other input (bfloat16
    under ``--bf16``) takes Flax's formula at the rounding points of
    ``afan``'s jitted steps (`flax/linen/normalization.py:_normalize`):
    ``x`` widened by the subtraction of the float32 mean, times
    ``rsqrt(var + eps) * scale`` plus the bias in one fused multiply-add
    (XLA fuses it), one rounding back to ``x``'s dtype. ``batch_norm``
    would fold the mean into the bias (``x * a + b``) and round
    elsewhere."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return torch.addcmul(self.bias.reshape(shape),
                             x - self.running_mean.reshape(shape),
                             mul.reshape(shape)).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """Trainable BatchNorm with ``afan``'s semantics (flax's
    ``nn.BatchNorm``, eps 1e-5), for the segmentation stack.

    In train mode it normalizes with the batch statistics. Its running
    statistics are an EMA with weight ``momentum`` (0.01: flax's decay 0.99,
    ``afan/models/deeplab/modeling.py:31-32``) of the batch mean and the
    *biased* batch variance; ``nn.BatchNorm2d`` keeps the unbiased one. With
    ``update_stats`` False (:func:`frozen_bn_stats`) a train-mode forward
    leaves the running statistics untouched. Eval mode normalizes with
    them. Inside a data-parallel group of more than one rank a train-mode
    forward takes the global batch's statistics (:meth:`_global_forward`);
    with one rank it is the single-process path, bit for bit."""

    def __init__(self, num_features: int, momentum: float = 0.01,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if mesh.world_size() > 1:
            return self._global_forward(x)
        if not self.update_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        # With momentum 1 the normalizing pass itself writes the batch mean
        # and unbiased variance into these scratch buffers.
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over data-parallel ranks: the statistics of the
        global batch, as ``afan``'s BatchNorm computes them under a mesh
        (flax's ``mean(x)`` and ``mean(x^2) - mean(x)^2`` in float32).
        The per-channel sum, sum of squares and count are summed over the
        ranks with autograd (:func:`afan_torch.parallel.mesh.sum_over_ranks`),
        so the backward carries every rank's terms; the same global mean
        and biased variance feed the running statistics' EMA. A float64
        input (a model in float64, as the CPU tests run one) keeps float64
        statistics."""
        c = x.shape[1]
        xf = x if x.dtype == torch.float64 else x.float()
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype,
                           device=x.device)
        stats = mesh.sum_over_ranks(torch.cat(
            [xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]))
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return torch.addcmul(self.bias.reshape(shape),
                             x - mean.reshape(shape),
                             mul.reshape(shape)).to(x.dtype)


@contextlib.contextmanager
def frozen_bn_stats(module: nn.Module) -> Iterator[None]:
    """Train-mode forwards inside the block normalize with batch statistics
    but leave every :class:`BatchNorm`'s running statistics as they are."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


def stem_pool(x: torch.Tensor, key) -> torch.Tensor:
    """The stem's 3x3 stride-2 max pool (padding 1). Inside a row-sharded
    step, from the window of input rows its output rows read (-inf rows
    past the image's edges), with no row padding; ``key`` names the call
    (the stem's module)."""
    sh = spatial.active()
    if sh is None:
        return F.max_pool2d(x, 3, stride=2, padding=1)
    n = sh.global_height((key, "pool"), x.shape[2])
    _, windows = spatial.conv_windows(sh, n, 3, 2, 1, 1)
    x = spatial.window_rows(x, n, windows, float("-inf"))
    if x.shape[2] == 0:
        return spatial.no_rows(
            (x.shape[0], x.shape[1], 0, (x.shape[3] - 1) // 2 + 1),
            x.dtype, x)
    return F.max_pool2d(x, 3, stride=2, padding=(0, 1))


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=(k // 2) * dilation,
                  dilation=dilation, bias=False)


def _downsample(cin: int, cout: int, stride: int, norm: Type[nn.Module]
                ) -> Optional[nn.Sequential]:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), norm(cout))


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 reduce → 3x3 (stride, dilation) → 1x1
    expand (x4), projection shortcut on a shape change."""
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, norm: Type[nn.Module] = FrozenBatchNorm):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = norm(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = norm(out)
        self.downsample = _downsample(cin, out, stride, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class BasicBlockI(nn.Module):
    """torchvision BasicBlock (ResNet-18/34); as in ``afan``, a dilated
    block dilates its first conv only."""
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, norm: Type[nn.Module] = FrozenBatchNorm):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride, dilation)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = norm(planes)
        self.downsample = _downsample(cin, planes, stride, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


# dilation of layer1..4 per output stride (`afan/models/resnet.py:194-202`)
_DILATIONS = {32: (1, 1, 1, 1), 16: (1, 1, 1, 2), 8: (1, 1, 2, 4)}


class ResNetTorso(nn.Module):
    """Stem + layer1..4 with a tap-indexed split forward (taps 1..4 = exit
    after layer1..4).

    ``output_stride`` 16 dilates layer4, 8 dilates layer3 and layer4, with
    torchvision's rule: a dilated stage moves its stride into the dilation
    and its first block keeps the previous stage's dilation. ``norm`` is
    :class:`FrozenBatchNorm` (detection) or :class:`BatchNorm`
    (segmentation).

    ``remat`` (``afan``'s ``ResNetTorso.remat``: one bool for the four
    stages or a per-stage 4-sequence, e.g. ``(1, 1, 0, 0)``) recomputes
    those of layer1..4 (never the stem) in the backward of every
    grad-requiring pass, the ascents' ``autograd.grad`` through a tail
    included (:func:`afan_torch.train.remat.remat`). The default is off;
    ``afan``'s default is on, which its detection stack keeps, while the
    port's detection stack does not recompute (the function is the same;
    ``README.md`` says why)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 block: type = Bottleneck, output_stride: int = 32,
                 norm: Type[nn.Module] = FrozenBatchNorm,
                 remat: Union[bool, Sequence[bool]] = False):
        super().__init__()
        if output_stride not in _DILATIONS:
            raise ValueError(f"output_stride must be one of "
                             f"{sorted(_DILATIONS)}, got {output_stride}")
        self.remat = (tuple(bool(r) for r in remat)
                      if isinstance(remat, (tuple, list)) else
                      (bool(remat),) * 4)
        if len(self.remat) != 4:
            raise ValueError(f"remat needs one entry per stage, got {remat}")
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = norm(64)
        cin, prev_dil = 64, 1
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            dil = _DILATIONS[output_stride][i]
            stride = 1 if (i == 0 or dil > prev_dil) else 2
            blocks = []
            for j in range(n):
                blocks.append(block(cin, planes, stride if j == 0 else 1,
                                    prev_dil if j == 0 else dil, norm))
                cin = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            prev_dil = dil
        self.register_buffer(
            "mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1),
            persistent=False)

    @property
    def stages(self):
        return (self.layer1, self.layer2, self.layer3, self.layer4)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - self.mean) / self.std
        x = F.relu(self.bn1(self.conv1(x)))
        return stem_pool(x, self)

    def forward(self, x: torch.Tensor, start: int = 0, end: int = 4
                ) -> torch.Tensor:
        """Run layers (start, end] on NCHW ``x``."""
        if start == 0:
            x = self.stem(x)
        for i in range(start, end):
            x = self.run_stage(x, i)
        return x

    def head(self, x: torch.Tensor, tap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image → (feature after layer ``tap``, ``low_level`` = the feature
        after layer1)."""
        low_level = self.run_stage(self.stem(x), 0)
        return self.forward(low_level, 1, tap), low_level

    def tail(self, feature: torch.Tensor, tap: int, end: int = 4
             ) -> torch.Tensor:
        """Resume from a (possibly adversarial) layer-``tap`` feature."""
        return self.forward(feature, tap, end)

    def run_stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """Apply one layer (the detection 'hidden' = layer4 on pooled
        ROIs), recomputed in the backward where ``remat`` says so."""
        layer = self.stages[stage]
        if self.remat[stage]:
            return remat(layer, x, module=layer)
        return layer(x)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: kaiming-normal (fan_out, gain 2) conv kernels and
        identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


def resnet18(**kw) -> ResNetTorso:
    return ResNetTorso((2, 2, 2, 2), BasicBlockI, **kw)


def resnet50(**kw) -> ResNetTorso:
    return ResNetTorso((3, 4, 6, 3), Bottleneck, **kw)


def resnet101(**kw) -> ResNetTorso:
    return ResNetTorso((3, 4, 23, 3), Bottleneck, **kw)


BACKBONES = {"resnet18": resnet18, "resnet50": resnet50,
             "resnet101": resnet101}


def from_name(name: str, **kw) -> ResNetTorso:
    """Backbone registry; ``kw`` goes to :class:`ResNetTorso`
    (``output_stride``, ``norm``, ``remat``)."""
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; have {list(BACKBONES)}")
    return BACKBONES[name](**kw)


# channels out of layer3 (detection features) / layer4 (hidden) per arch
NUM_FEATURES_OUT = {"resnet18": 256, "resnet50": 1024, "resnet101": 1024}
NUM_HIDDEN_OUT = {"resnet18": 512, "resnet50": 2048, "resnet101": 2048}
# channels of ``low_level`` (layer1) per arch
NUM_LOW_LEVEL_OUT = {"resnet18": 64, "resnet50": 256, "resnet101": 256}
