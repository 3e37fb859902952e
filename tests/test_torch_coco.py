"""afan_torch's COCO detection and RPN SD tap against afan's.

- ``load_coco_samples`` on a json the test writes (crowds, a subset, images
  without annotations): the port's samples equal ``afan``'s one by one, and
  each package reads only its own parse cache (``afan``'s pickles its
  ``DetSample``, which would import JAX into the port).
- ``detection_loaders`` for every dataset name and its hyphenated spelling:
  ``afan``'s class count; the COCO and cat/dog synthetic fallbacks byte
  for byte.
- ``coco_bbox_ap`` / ``format_coco_summary`` on random detections over
  crowds and every area range: within 1e-12 of ``afan``, the same string;
  ``DetectionEvaluator(protocol="coco")`` gives ``afan``'s AP and summary.
- ``rpn_head_forward`` / ``rpn_tail_losses`` and one ``sd="rpn"`` A-FAN
  step (the RPN tap alone, ``--sd_only``) on
  ``tests/test_torch_detect_train.py``'s tiny model, with
  ``afan``'s sampling uniforms injected (the two frameworks' random draws
  never match), at that file's tolerances (1e-4); the step's proposal NMS
  and PGD-update launches as ``chip_smoke.det_launches_per_step`` counts
  them.
- ``recipes/detect_coco_final_setting.sh`` 1-6 parse flag for flag as
  ``afan``'s parser reads them and build ``afan``'s model and A-FAN
  configurations; ``train_detect -s coco2017 --pertub_idx_sd rpn`` runs on
  the CPU.
"""
import ast
import itertools
import json
import os
import pickle
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.cli import train_detect as j_train_detect
from afan.data import coco as j_coco
from afan.data import registry as j_registry
from afan.eval import coco_map as j_coco_map
from afan.eval import det_map as j_det_map
from afan.models.frcnn import FRCNNConfig as JFRCNNConfig
from afan.train import detect_loop as j_loop
from afan.train.loop import TrainState
from afan.train.optim import warmup_multistep_schedule as j_schedule
from afan_torch.cli import train_detect
from afan_torch.core import attack
from afan_torch.data import coco, registry
from afan_torch.eval import coco_map, det_map
from afan_torch.models.frcnn import FRCNNConfig
from afan_torch.ops import nms as tnms
from afan_torch.train import detect_loop
from afan_torch.train.optim import sgd, warmup_multistep_schedule

import chip_smoke
from test_torch_detect_train import (B, LR, TINY, batched_priorities,
                                     batches_equal, close, close_losses,
                                     compare_states, counting, j_targets,
                                     port_model, setup,  # noqa: F401
                                     smoke_tiny_flags, t, to_torch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RPN = dict(taps_se=(2,), gammas_se=(1.0 / 255,), spectrum=2,
           mix_mask=(0, 1), sd="rpn", gamma_sd=0.5 / 255, mix_sd=True)
# the parity step: the RPN tap alone (``--sd_only``), which keeps the compile
# of afan's jitted step short; the SE terms are held by the VOC step tests
RPN_ONLY = dict(RPN, taps_se=(), gammas_se=())
# anchors of the tiny model: a 4x4 feature map x 2 sizes x 3 ratios
N_ANCHORS = 4 * 4 * 6


# ---------- COCO annotations ----------

def write_coco_json(path):
    """Six images: two with objects and crowds, one with only a crowd, one
    with nothing, one with only other categories, one with a car."""
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "width": 640 - i,
               "height": 480 + i} for i in (1, 2, 3, 4, 5, 6)]
    anns = []

    def ann(image, cat, box, crowd=0):
        anns.append({"id": len(anns) + 1, "image_id": image,
                     "category_id": cat, "bbox": box, "iscrowd": crowd})
    ann(1, 1, [10.5, 20.0, 100.0, 50.25])
    ann(1, 18, [200.0, 30.0, 40.0, 60.0])
    ann(1, 1, [0.0, 0.0, 300.0, 200.0], crowd=1)
    ann(2, 3, [5.0, 6.0, 7.0, 8.0])
    ann(2, 90, [50.0, 60.0, 70.0, 80.0])
    ann(2, 3, [100.0, 100.0, 150.0, 90.0], crowd=1)
    ann(3, 1, [1.0, 2.0, 3.0, 4.0], crowd=1)
    ann(5, 44, [11.0, 12.0, 13.0, 14.0])
    ann(6, 3, [20.0, 20.0, 30.0, 30.0])
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c} for c in (1, 3, 18, 44, 90)]},
                  f)


def samples_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in ("image_id", "image_path", "width", "height"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("boxes", "labels", "crowd_boxes", "crowd_labels"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("subset", list(coco.SUBSETS))
def test_coco_samples_match_afan(tmp_path, subset):
    path = str(tmp_path / "instances.json")
    write_coco_json(path)
    keep = coco.SUBSETS[subset]
    got = coco.load_coco_samples(path, "imgs", keep, use_cache=False)
    want = j_coco.load_coco_samples(path, "imgs", keep, use_cache=False)
    assert got[1] == want[1] == (len(keep) + 1 if keep else 92)
    samples_equal(got[0], want[0])


def test_each_package_reads_only_its_own_cache(tmp_path):
    path = str(tmp_path / "instances.json")
    write_coco_json(path)
    fresh = coco.load_coco_samples(path, "imgs", None, use_cache=False)
    port_cache = coco.cache_path(path, "imgs", None)
    samples_equal(coco.load_coco_samples(path, "imgs")[0], fresh[0])
    with open(port_cache, "rb") as f:
        assert b"afan.data" not in f.read()           # plain arrays only
    with open(port_cache, "wb") as f:                  # the port's own says 7
        pickle.dump({"samples": [], "num_classes": 7}, f)
    want = j_coco.load_coco_samples(path, "imgs")
    samples_equal(want[0], fresh[0])                   # afan parsed afresh
    afan_caches = [p for p in os.listdir(tmp_path) if ".afan_cache_" in p]
    assert len(afan_caches) == 1
    with open(tmp_path / afan_caches[0], "wb") as f:   # afan's own says 9
        pickle.dump(([], 9), f)
    assert coco.load_coco_samples(path, "imgs") == ([], 7)
    assert j_coco.load_coco_samples(path, "imgs") == ([], 9)


def test_a_coco_image_on_disk_is_not_decoded(tmp_path):
    os.makedirs(tmp_path / "COCO" / "annotations")
    for split in ("train", "val"):
        write_coco_json(str(tmp_path / "COCO" / "annotations"
                            / f"instances_{split}2017.json"))
    train, _, nc = registry.detection_loaders("coco2017-person",
                                              str(tmp_path), 1, 64, 96)
    assert nc == 2 and len(train.samples) == 1
    with pytest.raises(NotImplementedError, match="item 6"):
        next(iter(train))


NAMES = registry.DETECTION_DATASETS + ("voc2007-cat-dog", "coco2017-person",
                                       "coco2017-car", "coco2017-animal")


@pytest.mark.parametrize("name", NAMES)
def test_detection_loaders_take_every_name_as_afan(name):
    got = registry.detection_loaders(name, "/nonexistent", 2, 64, 96, 1)
    want = j_registry.detection_loaders(name, "/nonexistent", 2, 64, 96, 1)
    assert got[2] == want[2]
    if name.replace("-", "") in ("coco2017animal", "voc2007catdog"):
        for g, w in zip(got[:2], want[:2]):
            batches_equal(itertools.islice(g, 2), itertools.islice(w, 2))


def test_coco_recipe_canvas_and_classes():
    train, test, nc = registry.detection_loaders("coco2017", None, 8, 800,
                                                 1333)
    assert nc == 92 and train.fat_canvas == (800, 1344)
    assert len(train.samples) == 64 and len(test.samples) == 16


# ---------- COCO metrics ----------

def random_eval_set(seed):
    """Ground truth of every area range with crowd regions, and jittered,
    missing and false detections with distinct scores."""
    rng = np.random.RandomState(seed)
    gt, crowd, ids, boxes, classes = {}, {}, [], [], []
    for i in range(8):
        n = rng.randint(1, 7)
        side = rng.choice([12.0, 50.0, 150.0], n) * (0.7 + 0.6 * rng.rand(n))
        xy = rng.rand(n, 2) * 300
        b = np.concatenate([xy, xy + side[:, None]], 1)
        lab = rng.randint(1, 4, n)
        gt[f"im{i}"] = (b, lab)
        if i % 3 == 0:
            cxy = rng.rand(1, 2) * 200
            crowd[f"im{i}"] = (np.concatenate([cxy, cxy + 120], 1),
                               np.array([rng.randint(1, 4)]))
        for j in range(rng.randint(2, 12)):
            k = rng.randint(n)
            ids.append(f"im{i}")
            boxes.append(b[k] + rng.randn(4) * (2 if j % 3 else 20))
            classes.append(lab[k] if j % 4 else rng.randint(1, 4))
    probs = rng.permutation(len(ids)) / len(ids) + 0.01
    return gt, crowd, ids, np.array(boxes), np.array(classes), probs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_ap_and_summary_match_afan(seed):
    gt, crowd, ids, boxes, classes, probs = random_eval_set(seed)
    for cr in (crowd, None):
        got = coco_map.coco_bbox_ap(4, gt, ids, boxes, classes, probs, cr)
        want = j_coco_map.coco_bbox_ap(4, gt, ids, boxes, classes, probs, cr)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12, k
        assert (coco_map.format_coco_summary(got)
                == j_coco_map.format_coco_summary(want))
    assert 0.0 < got["AP"] < 1.0 and got["APs"] >= 0 and got["APl"] >= 0


def test_detection_evaluator_coco_protocol_matches_afan():
    """Both evaluators over the synthetic COCO test split (crowds added to
    two samples), fed the same detections per batch."""
    _, port_loader, nc = registry.detection_loaders("coco2017", None, 1, 64,
                                                    96)
    _, afan_loader, _ = j_registry.detection_loaders("coco2017", None, 1, 64,
                                                     96)
    for loader in (port_loader, afan_loader):
        for s in loader.samples[:2]:
            s.crowd_boxes = s.boxes[:1] + 5.0
            s.crowd_labels = s.labels[:1].copy()
    rng = np.random.RandomState(4)
    outputs = []
    for batch in port_loader:
        b, p, c = len(batch.image_ids), 6, nc
        gt = batch.boxes[:, :1, None, :] + rng.randn(b, p, c, 4) * 3
        outputs.append((gt.astype(np.float32),
                        rng.rand(b, p, c).astype(np.float32),
                        rng.rand(b, p, c) < 0.5))
    feed = iter(outputs)
    got = det_map.DetectionEvaluator(
        port_loader, lambda x: tuple(map(torch.from_numpy, next(feed))), nc,
        protocol="coco").evaluate()
    feed = iter(outputs)
    want = j_det_map.DetectionEvaluator(
        afan_loader, lambda state, x: next(feed), nc,
        protocol="coco").evaluate(None)
    assert got[0] == want[0] and got[1] == want[1]
    assert "maxDets=100" in got[1]


# ---------- the RPN SD tap ----------

def afan_sd_priorities(key):
    """The uniforms ``afan``'s ``rpn_tail_losses`` draws from its key: the
    anchors' from the first B keys, the proposals' from the last B."""
    keys = jax.random.split(key, 2 * B)
    return (batched_priorities(keys[:B], N_ANCHORS),
            batched_priorities(keys[B:], TINY["train_post_nms_top_n"]))


def test_rpn_head_and_tail_match_afan(setup):
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    key = jax.random.PRNGKey(13)
    x = jnp.asarray(images)

    def j_head_and_tail(v):
        """The head's dict; the tail's losses on its trunk feature x 1.1
        and their gradient there."""
        jd = jm.apply(v, x, method=jm.rpn_head_forward)

        def tail(rf):
            losses = jm.apply(v, jd, x.shape, *jgt, key, rf,
                              method=jm.rpn_tail_losses)
            return losses.total(), losses
        adv = jd["rpn_feature"] * 1.1
        return jd, adv, jax.value_and_grad(tail, has_aux=True)(adv)

    jd, adv, ((_, want), want_g) = jax.jit(j_head_and_tail)(variables)
    rd = tm.rpn_head_forward(t(images))
    close(rd["features"].detach().permute(0, 2, 3, 1).numpy(),
          jd["features"])
    close(rd["rpn_feature"].detach().permute(0, 2, 3, 1).numpy(),
          jd["rpn_feature"])
    assert rd["rpn_feature"].shape[1:] == (512, 4, 4)
    rf = t(adv).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    got = tm.rpn_tail_losses(rd, tuple(images.shape[1:3]), *tgt,
                             afan_sd_priorities(key), rf)
    close_losses(got, want, "rpn_tail")
    (g,) = torch.autograd.grad(got.total(), rf)
    close(g.permute(0, 2, 3, 1).numpy(), want_g, msg="SD gradient")


def rpn_step(variables, **kw):
    tm = port_model(variables)
    opt, sched = sgd(detect_loop.detection_param_groups(tm),
                     warmup_multistep_schedule(LR, [10], 0.1, 1.0 / 3, 5),
                     LR, 0.9, 5e-4)
    return tm, detect_loop.make_afan_det_step(
        tm, opt, sched, detect_loop.DetAfanConfig(**dict(RPN, **kw)))


def test_afan_step_with_the_rpn_tap_matches_afan(setup):
    jm, variables, images, jgt, tgt = setup
    tx = j_loop.detection_tx(j_schedule(LR, [10], 0.1, 1.0 / 3, 5), 0.9,
                             5e-4)
    state = jax.jit(lambda v: TrainState.create(v, tx))(variables)
    key = jax.random.PRNGKey(14)
    jstep = j_loop.make_afan_det_step(jm, tx, j_loop.DetAfanConfig(
        **RPN_ONLY))
    # the step's own key split (`afan/train/detect_loop.py:221`)
    _, r_sd, r_clean, _, _, _ = jax.random.split(key, 6)
    targets = {"clean": to_torch(j_targets(jm, variables, images, jgt,
                                           r_clean)),
               "sd_priorities": afan_sd_priorities(r_sd)}
    state, metrics = jstep(state, jnp.asarray(images), *jgt, key)
    tm, step = rpn_step(variables, **RPN_ONLY)
    out = step(t(images), *tgt, targets=targets)
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        close(float(out[k]), float(metrics[k]), msg=k)
    assert float(out["loss_sd"]) > 0
    compare_states(tm, variables, state)


@pytest.mark.parametrize("share", [True, False], ids=["shared", "resample"])
def test_rpn_step_runs_the_proposal_nms_and_updates_per_step(
        setup, monkeypatch, share):
    """With ``share_proposals`` the shared sample, one NMS per SD ascent
    step and one for the SD loss term; without it one per sampling
    forward; one PGD update per tap and step."""
    _, variables, images, _, tgt = setup
    kw = dict(share_proposals=share, steps=2, noise_sd=0.5)
    tm, step = rpn_step(variables, **kw)
    want = chip_smoke.det_launches_per_step(
        detect_loop.DetAfanConfig(**dict(RPN, **kw)))
    nms_calls = counting(monkeypatch, tnms, "nms_sorted_mask")
    updates = counting(monkeypatch, attack, "pgd_update")
    out = step(t(images), *tgt, torch.Generator().manual_seed(0))
    assert np.isfinite([float(v) for v in out.values()]).all()
    assert (len(nms_calls), len(updates)) == want
    assert want == ((4, 4) if share else (7, 4))


# ---------- the COCO recipes and the CLI ----------

def coco_recipe_flags(n):
    """The flags ``recipes/detect_coco_final_setting.sh n`` passes to afan's
    detection CLI, its data flag left out."""
    with open(os.path.join(ROOT, "recipes",
                           "detect_coco_final_setting.sh")) as f:
        text = f.read()
    knobs = next(ln for ln in text.splitlines()
                 if ln.strip().startswith(f"{n})")).split('KNOBS="')[1]
    text = text.replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "-m afan.cli.train_detect" in ln)
    line = (line.replace('"${OUT}"', f"./outputs/coco_final{n}")
            .replace("${KNOBS}", knobs.split('"')[0])
            .replace("$(det_smoke_flags)", ""))
    assert "$" not in line, line
    argv = shlex.split(line)
    return argv[argv.index("afan.cli.train_detect") + 1:]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_coco_recipes_parse_and_build_afans_configs(n):
    flags = coco_recipe_flags(n)
    args = train_detect.get_parser().parse_args(flags)
    j_args = j_train_detect.get_parser().parse_args(flags)
    got, want = vars(args), vars(j_args)
    assert {k: got[k] for k in want} == want
    assert args.bf16 and args.dataset == "coco2017"
    cfg = train_detect.afan_config_for(args)
    assert j_train_detect.afan_config_for(j_args) == j_loop.DetAfanConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    model = train_detect.frcnn_config(args, coco.NUM_COCO_CLASSES)
    assert model.anchor_sizes == (64, 128, 256, 512)
    assert model.anchor_smooth_l1_beta == 0.1111
    # afan's main builds its FRCNNConfig from the same flags
    j_model = JFRCNNConfig(
        backbone=j_args.backbone, num_classes=coco.NUM_COCO_CLASSES,
        anchor_sizes=tuple(ast.literal_eval(j_args.anchor_sizes)),
        anchor_ratios=tuple(ast.literal_eval(j_args.anchor_ratios)),
        train_pre_nms_top_n=j_args.rpn_pre_nms_top_n,
        train_post_nms_top_n=j_args.rpn_post_nms_top_n,
        anchor_smooth_l1_beta=j_args.anchor_smooth_l1_loss_beta,
        proposal_smooth_l1_beta=j_args.proposal_smooth_l1_loss_beta,
        pooler_mode=j_args.pooler_mode)
    assert {f: getattr(model, f) for f in model.__dataclass_fields__} == {
        f: getattr(j_model, f) for f in j_model.__dataclass_fields__}
    assert model == FRCNNConfig(**{f: getattr(j_model, f)
                                   for f in j_model.__dataclass_fields__})


def test_cli_runs_coco_with_the_rpn_tap_on_cpu(tmp_path):
    """A COCO subset (its final eval by the COCO protocol) with the RPN SD
    tap: one step with SMOKE_TINY's flags on half its canvas."""
    out = str(tmp_path)
    half = {"64": "32", "96": "48", "2": "1"}
    flags = [half.get(a, a) for a in smoke_tiny_flags()]
    mean_ap = train_detect.main(
        ["--device", "cpu", "--variant", "afan", "-o", out, "-s",
         "coco2017-person", "--pertub_idx_sd", "rpn", "--mix_sd"] + flags)
    assert 0.0 <= mean_ap <= 1.0
    assert os.path.isfile(os.path.join(out, "model-1.pt"))
