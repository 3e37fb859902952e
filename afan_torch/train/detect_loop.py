"""Detection train steps — the PyTorch counterpart of
``afan/train/detect_loop.py``: the baseline step (`train_baseline.py`), the
input-adversarial step (`train_baseline_advtrain.py`), the A-FAN family
(`train_aug_final.py`: SE backbone tap, SD tap on the pooled ROI vector or
on the RPN trunk feature, spectrum, AFN; and its SAT, multi-layer and
single-point variants) and the eval forward.

Every forward that samples anchors and proposals runs the proposal NMS,
which on the card is the hand-written kernel
(:func:`afan_torch.ops.nms.nms_select_presorted`), and every sign ascent
ends in the PGD-update kernel (:func:`afan_torch.core.attack.pgd`). There is
no fallback: a kernel that fails raises.

Freeze (`Detection/backbone/resnet50.py:36-38`, ``afan``'s
``detection_param_labels``): the stem, ``layer1`` and every FrozenBatchNorm
weight and bias of the torso (``layer4`` too, which ``detection.hidden``
shares) take no update and no weight decay; :func:`detection_param_groups`
turns their gradients off and leaves them out of the optimizer.

Images enter as ``(B, H, W, 3)`` in [0, 1], ground truth as boxes
``(B, G, 4)``, classes ``(B, G)`` and validity ``(B, G)``, on the model's
device.

Under a bfloat16 model (``--bf16``) the steps keep ``afan``'s dtypes: the
SE and SD features are bfloat16 and so are their ascents (the PGD-update
kernel's bfloat16 path, step sizes rounded to bfloat16), the spectrum and
AFN run on bfloat16 features, the ``noise_sd`` noise is drawn in float32
(``afan``'s ``uniform_init`` default) and promotes the SD point, and each
loss term is float32 (its smooth-L1 parts are).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..core.afn import mix_feature
from ..core.attack import input_pgd, pgd, uniform_init
from ..core.spectrum import sample_points
from ..models.frcnn.model import FasterRCNN, Targets
from ..models.resnet import FrozenBatchNorm
from ..ops.lowp import mean

UNPORTED = "not ported yet (ROADMAP.md, queue 1: detection)"


def detection_param_groups(model: FasterRCNN, freeze: bool = True
                           ) -> List[dict]:
    """The SGD groups of a detection model. With ``freeze`` (the
    reference's setting; it always starts from ImageNet weights), the
    stem, ``layer1`` and every FrozenBatchNorm weight and bias of the torso
    get ``requires_grad_(False)`` and stay out of the groups; without it
    (training from scratch) every parameter trains."""
    if freeze:
        torso = model.features
        frozen = [torso.conv1, torso.bn1, torso.layer1] + [
            m for m in torso.modules() if isinstance(m, FrozenBatchNorm)]
        for m in frozen:
            m.requires_grad_(False)
    return [{"params": [p for p in model.parameters() if p.requires_grad]}]


StepFn = Callable[..., Dict[str, torch.Tensor]]


def make_baseline_det_step(model: FasterRCNN,
                           optimizer: torch.optim.Optimizer, scheduler
                           ) -> StepFn:
    """`train_baseline.py:74-90`: loss = the four losses' means summed, one
    SGD update. ``step(images, gt_boxes, gt_classes, gt_valid,
    generator=None, targets=None) -> {"loss"}``; ``targets`` replace the
    sample drawn from ``generator``."""

    def step_fn(images, gt_boxes, gt_classes, gt_valid,
                generator: Optional[torch.Generator] = None,
                targets: Optional[Targets] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = model.losses(images, gt_boxes, gt_classes, gt_valid,
                            generator, targets=targets).total()
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach()}

    return step_fn


def make_advtrain_det_step(model: FasterRCNN,
                           optimizer: torch.optim.Optimizer, scheduler,
                           steps: int = 5, gamma: float = 2.0 / 255,
                           eps: float = 8.0 / 255, randinit: bool = True
                           ) -> StepFn:
    """Input-PGD adversarial training (`train_baseline_advtrain.py:75-89`):
    ``steps`` ascent steps on the image through the four losses, no
    projection, a clamp to [0, 1], then one SGD update on the adversarial
    image's losses alone. Each forward samples its own anchors and
    proposals, so a step runs ``steps + 1`` proposal NMS.
    ``step(images, gt_boxes, gt_classes, gt_valid, generator=None) ->
    {"loss"}``; ``generator`` drives the samples and ``randinit``."""

    def step_fn(images, gt_boxes, gt_classes, gt_valid,
                generator: Optional[torch.Generator] = None):
        model.train()
        gt = (gt_boxes, gt_classes, gt_valid)
        adv = input_pgd(lambda x: model.losses(x, *gt, generator).total(),
                        images, steps=steps, gamma=gamma, eps=eps,
                        randinit=randinit, generator=generator)
        optimizer.zero_grad(set_to_none=True)
        loss = model.losses(adv, *gt, generator).total()
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach()}

    return step_fn


@dataclasses.dataclass(frozen=True)
class DetAfanConfig:
    """The A-FAN detection flags (`train_aug_final.py:200-247` and the
    variants), gammas ALREADY /255. ``taps_se`` holds the SE taps (the
    first carries the spectrum; more than one is the multi-layer variants'
    extra points, an empty tuple is SD only)."""
    taps_se: Sequence[int] = (2,)
    gammas_se: Sequence[float] = (0.9 / 255,)
    spectrum: int = 5
    mix_mask: Sequence[int] = (0, 0, 0, 0, 0)  # AFN per spectrum point
    sd: Optional[str] = "roi"                  # 'roi' | 'rpn' | None
    gamma_sd: float = 0.1 / 255
    only_roi_sd: bool = True
    mix_sd: bool = False
    noise_sd: float = 0.0
    sd_weight: float = 0.3
    steps: int = 1
    eps: float = 2.0 / 255
    randinit: bool = False
    clip: bool = False
    step_mode: str = "sign"
    random_steps: bool = False
    remat_tails: bool = False
    # 'final' (`train_aug_final.py:156`), 'sat_preset'
    # (`train_aug_sat_advt.py:119-132`, by loss_setting) or 'single'
    # (`train_aug_single_advt.py:95`); the last two leave SD out of the loss
    weight_mode: str = "final"
    loss_setting: int = 1
    share_proposals: bool = True
    # the *_advt variants: the clean term's forward takes an input-PGD
    # image (`train_aug_sat_advt.py:78`)
    input_adv: bool = False
    input_adv_steps: int = 5
    input_adv_gamma: float = 0.3 / 255
    input_adv_eps: float = 2.0 / 255


# sat_preset: loss = a * lca + b * l0 with lca = 0.2 * (l0 + the SE terms)
SAT_PRESETS = {1: (1.0, 0.0), 2: (0.5, 0.5), 3: (0.4, 0.6), 4: (0.3, 0.7)}


def loss_weights(cfg: DetAfanConfig) -> Tuple[float, float, float]:
    """The weights of the clean loss, of each SE term (spectrum tail or
    extra tap) and of the SD loss under ``cfg``'s weight mode."""
    if cfg.weight_mode == "final":
        w_sd = cfg.sd_weight if cfg.sd is not None else 0.0
        return (1.0 - w_sd) / 3.0, (1.0 - w_sd) / 3.0, w_sd / 3.0
    if cfg.weight_mode == "single":
        return 0.5, 0.5, 0.0
    if cfg.weight_mode == "sat_preset" and cfg.loss_setting in SAT_PRESETS:
        a, b = SAT_PRESETS[cfg.loss_setting]
        return 0.2 * a + b, 0.2 * a, 0.0
    raise ValueError(f"weight_mode {cfg.weight_mode!r} with loss_setting "
                     f"{cfg.loss_setting} is not a preset")


def _refuse_unported(cfg: DetAfanConfig) -> None:
    if cfg.sd not in ("roi", "rpn", None):
        raise ValueError(f"unknown sd tap {cfg.sd!r}")
    if cfg.remat_tails:
        raise NotImplementedError(f"remat_tails is {UNPORTED}")
    if cfg.taps_se and len(cfg.mix_mask) != cfg.spectrum:
        raise ValueError(f"mix_mask {cfg.mix_mask} needs {cfg.spectrum} "
                         f"entries")


def make_afan_det_step(model: FasterRCNN, optimizer: torch.optim.Optimizer,
                       scheduler, cfg: DetAfanConfig) -> StepFn:
    """The A-FAN detection step (`train_aug_final.py:70-166` and the
    variants):

    0. with ``input_adv``, input PGD (random start, projection) on the
       image; only the clean loss term sees the result;
    1. the SE features at each tap, detached;
    2. the SD pass: a clean forward to the pooled ROI vector, detached,
       with its sample (``sd="roi"``), or to the RPN trunk feature
       (``sd="rpn"``), detached;
    3. PGD on each SE feature through the four losses, and on the ROI
       vector through the ROI losses (``only_roi_sd``) or all four, or on
       the trunk feature through the RPN tail's four losses;
    4. AFN and uniform noise on the SD point (``mix_sd``, ``noise_sd``);
    5. the spectrum on the first SE tap, AFN per ``mix_mask``;
    6. loss = the weight mode's mix (:func:`loss_weights`; ``final``:
       (clean + spectrum tails + extra taps) / 3 * (1 - w) + SD / 3 * w),
       one SGD update. The other modes leave the SD loss out; it is still
       computed and reported.

    With ``share_proposals`` one clean forward samples the targets that
    the ascents (the input ascent too) and the loss forwards reuse;
    otherwise each forward samples its own. The ROI SD pass samples once:
    the loss's SD term reuses that sample (``afan`` draws it twice from one
    key, which gives the same sample), on the RPN outputs of the clean
    image: the clean term's forward's, or under ``input_adv`` a forward of
    its own. The RPN SD tail makes its proposals from its own (adversarial)
    predictions in every forward, whatever ``share_proposals`` says, each
    time from the same priorities (``afan``'s one key); its loss term pools
    from the clean term's features (without ``input_adv``). So a step runs
    2 proposal NMS with ``share_proposals`` and the ROI tap, 2 + ``steps``
    with the RPN tap, 1 without a tap (one per sampling forward without
    ``share_proposals``), and one PGD update per ascent step and tap.

    Each loss term is backpropagated as soon as it is formed (the terms
    share no activations but the clean forward's), so one forward's graph
    is alive at a time; the update is the one of the summed loss.

    ``step(images, gt_boxes, gt_classes, gt_valid, generator=None,
    targets=None)`` returns the detached ``loss``, ``loss_clean``,
    ``loss_spectrum`` and ``loss_sd``. ``generator`` drives the samples,
    the input ascent's random start, ``randinit``, ``random_steps`` and
    ``noise_sd``; ``targets`` may hold ``"clean"`` (the sample ``afan``
    draws from its ``r_clean`` key: the shared one, or the clean forward's)
    and ``"sd"`` (the ROI SD pass's) or ``"sd_priorities"`` (the RPN SD
    tail's uniforms, :meth:`FasterRCNN.draw_priorities`), which then are
    not drawn.
    """
    _refuse_unported(cfg)
    c_clean, c_se, c_sd = loss_weights(cfg)

    def attack(loss_fn, x, gamma, generator):
        return pgd(loss_fn, x, steps=cfg.steps, gamma=gamma, eps=cfg.eps,
                   randinit=cfg.randinit, clip=cfg.clip, generator=generator,
                   step_mode=cfg.step_mode, random_steps=cfg.random_steps)

    def step_fn(images, gt_boxes, gt_classes, gt_valid,
                generator: Optional[torch.Generator] = None,
                targets: Optional[Mapping[str, Targets]] = None):
        model.train()
        targets = dict(targets or {})
        gt = (gt_boxes, gt_classes, gt_valid)
        hw = tuple(images.shape[1:3])
        shared = None
        if cfg.share_proposals:
            shared = targets.get("clean")
            if shared is None:
                shared = model.compute_targets(images, *gt, generator)

        def tail_loss(tap, feat):
            return model.losses(images, *gt, generator, tap, feat,
                                shared).total()

        images_l0 = images
        if cfg.input_adv:
            images_l0 = input_pgd(
                lambda x: model.losses(x, *gt, generator,
                                       targets=shared).total(),
                images, steps=cfg.input_adv_steps,
                gamma=cfg.input_adv_gamma, eps=cfg.input_adv_eps,
                randinit=True, clip=True, generator=generator,
                step_mode=cfg.step_mode, random_steps=cfg.random_steps)

        with torch.no_grad():
            se_feats = [model.backbone_head(images, tap)
                        for tap in cfg.taps_se]
        se_advs = [attack(lambda f, tap=tap: tail_loss(tap, f), feat, g,
                          generator)
                   for tap, feat, g in zip(cfg.taps_se, se_feats,
                                           cfg.gammas_se)]

        adv_sd = sd_targets = sd_priorities = None
        if cfg.sd == "roi":
            with torch.no_grad():
                rd = model.roi_head_forward(images, *gt, generator,
                                            targets.get("sd"))
            sd_targets, sd_clean = rd["targets"], rd["roi_feature_map"]

            def sd_loss(rf):
                L = model.roi_tail_losses(rd, rf)
                if cfg.only_roi_sd:
                    return mean(L.proposal_class) + \
                        mean(L.proposal_transformer)
                return L.total()
        elif cfg.sd == "rpn":
            with torch.no_grad():
                rd = model.rpn_head_forward(images)
            sd_clean = rd["rpn_feature"]
            sd_priorities = targets.get("sd_priorities")
            if sd_priorities is None:
                sd_priorities = model.draw_priorities(rd["features"], hw,
                                                      generator)

            def sd_loss(rf):
                return model.rpn_tail_losses(rd, hw, *gt, sd_priorities,
                                             rf).total()
        if cfg.sd is not None:
            adv_sd = attack(sd_loss, sd_clean, cfg.gamma_sd, generator)
            if cfg.mix_sd:
                adv_sd = mix_feature(sd_clean, adv_sd)
            if cfg.noise_sd:
                adv_sd = adv_sd + uniform_init(
                    adv_sd.shape, cfg.gamma_sd * cfg.noise_sd, generator,
                    torch.float32, adv_sd.device)
            del rd, sd_clean

        spec_feats = []
        if cfg.taps_se:
            with torch.no_grad():
                spec = sample_points(se_feats[0], se_advs[0], cfg.spectrum)
                spec_feats = [mix_feature(se_feats[0], spec[i])
                              if cfg.mix_mask[i] else spec[i]
                              for i in range(1, cfg.spectrum)]
            del spec

        def sd_term(features, rpn_out):
            """The SD loss on the clean image's ``features`` (the RPN tail)
            or RPN outputs (the ROI tail)."""
            if cfg.sd == "rpn":
                return model.rpn_tail_losses({"features": features}, hw,
                                             *gt, sd_priorities,
                                             adv_sd).total()
            return model.roi_tail_losses(
                model.roi_dict(*rpn_out, sd_targets), adv_sd).total()

        optimizer.zero_grad(set_to_none=True)
        # the clean term's forward; without input_adv the SD term's RPN
        # losses use its RPN outputs, which are the clean image's
        features = model.features_clean(images_l0.permute(0, 3, 1, 2))
        rpn_out = model.rpn(features)
        clean = shared if shared is not None else targets.get("clean")
        l0 = model._losses_from_features(features, hw, *gt, generator, clean,
                                         rpn_out).total()
        first = c_clean * l0
        l_sd = torch.zeros_like(l0)
        if cfg.sd is not None and not cfg.input_adv:
            with torch.set_grad_enabled(c_sd > 0):
                l_sd = sd_term(features, rpn_out)
            if c_sd:
                first = first + c_sd * l_sd
        first.backward()
        del features, rpn_out, first
        if cfg.sd is not None and cfg.input_adv:
            with torch.set_grad_enabled(c_sd > 0):
                feats = model.features_clean(images.permute(0, 3, 1, 2))
                l_sd = sd_term(feats, model.rpn(feats)
                               if cfg.sd == "roi" else None)
            if c_sd:
                (c_sd * l_sd).backward()

        # the spectrum tails, then the extra taps' points, one at a time
        extra = [(cfg.taps_se[0], f) for f in spec_feats] + list(
            zip(cfg.taps_se[1:], se_advs[1:]))
        terms = []
        for tap, feat in extra:
            term = tail_loss(tap, feat)
            (c_se * term).backward()
            terms.append(term.detach())
        optimizer.step()
        scheduler.step()
        zero = torch.zeros_like(l0)
        l_spectrum = sum(terms[:len(spec_feats)], zero)
        l_multi = sum(terms[len(spec_feats):], zero)
        loss = (c_clean * l0.detach() + c_se * (l_spectrum + l_multi)
                + c_sd * l_sd.detach())
        return {"loss": loss, "loss_clean": l0.detach(),
                "loss_spectrum": l_spectrum, "loss_sd": l_sd.detach()}

    return step_fn


def make_detect_fn(model: FasterRCNN
                   ) -> Callable[[torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]]:
    """Eval forward → (boxes, probs, keep) on the model's device, under
    ``torch.inference_mode``; the probabilities widened to float32 (a
    bfloat16 model's are bfloat16). Images (B, H, W, 3) in [0, 1] may come from
    the host; they are copied to the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def detect(images: torch.Tensor):
        boxes, probs, keep = model.detect(images.to(device, torch.float32))
        return boxes, probs.float(), keep

    return detect
