"""afan_torch under bfloat16 (``--bf16``) against afan's bfloat16 path.

- The PGD update on bf16 tensors: the port's plain version (what the CUDA
  kernel's bf16 path is held to on the card, bit for bit) against
  ``afan``'s Pallas kernels in interpret mode, bit-equal, clipped and not,
  with step sizes below half a bf16 ulp of most entries (the recipes' SE
  step: gamma 0.02/255 to 0.03/255 rounds back to x wherever
  |x| > ~0.02).
- The plain upsample + CE on bf16 logits against ``afan``'s
  ``fused_resize_nll_sums(..., interpret=True)`` on the same logits: float32
  sums within 1e-5 of their largest (float32 sums in another order, as
  ``tests/test_torch_resize_ce.py``), the bf16 gradient within one bf16 ulp
  (both round the same float32 gradient, which differs in its last float32
  bits, so an entry near a rounding boundary may land one ulp apart).
- The bf16 model: the resize, the image pooling and BatchNorm follow
  ``afan``'s dtypes, and the logits of a forward agree with ``afan``'s bf16
  forward within twice ``afan``'s own bf16-vs-f32 gap.
- One bf16 A-FAN step with ``recipes/seg_voc07_final1.sh``'s flags at
  small width (DeepLabv3+ ResNet-18, 21 classes, 33x33 crops, batch 4)
  against ``afan``'s bf16 step with ``fused_ce=True`` (its loss sites on the
  kernel's float32 path, as on the TPU), from the same weights, with ASPP's
  dropout off on both sides. Tolerance: the port-vs-``afan`` gap of the
  loss, and of each updated parameter (by norm), is at most twice
  ``afan``'s own bf16-vs-f32 gap on the same inputs plus 1e-3 of the
  compared norm (parameters whose update is far below a bf16 ulp of their
  values show the same bf16 rounding noise in both frameworks but no
  measurable f32 gap). bf16 keeps 8 bits: two programs that round at the
  same points but sum convolutions in another order part by about as much
  as one program parts from itself in f32. The test prints both gaps.
- The SD noise is drawn in float32, as ``afan``'s ``uniform_init`` default
  draws it, and promotes the SD feature.
"""
import os
import shlex

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.cli import train_segment as j_train_segment
from afan.models.deeplab import modeling as jmodeling
from afan.ops.kernels.pgd_step import pgd_update_pallas
from afan.ops.kernels.resize_ce_kernel import \
    fused_resize_nll_sums as j_fused
from afan.train import segment_loop as jloop
from afan.train.loop import TrainState
from afan.train.optim import poly_schedule as j_poly
from afan_torch.cli import train_segment
from afan_torch.core import afn, attack
from afan_torch.interop.from_jax import deeplab_variables_to_state_dict
from afan_torch.models.deeplab import DeepLab
from afan_torch.models.deeplab.heads import GlobalMean, resize_bilinear
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.ops import pgd_step
from afan_torch.ops import resize_ce as rce
from afan_torch.train import segment_loop
from afan_torch.train.optim import poly_schedule, sgd
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
B, HW, NC, LR, TOTAL = 4, 33, 21, 0.01, 15000


def to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def bf16_bits(a):
    """The bits of a bf16 array (torch or JAX) as uint16."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def bf16_inputs(shape, seed):
    """Seeded bf16 x, g, c with a zero gradient entry and small x entries.
    Signed zeros and denormal gradients stay out: there the two
    frameworks' CPU ``sign`` differ (``tests/test_torch_pgd_step.py``)."""
    gen = torch.Generator().manual_seed(seed)
    x, g, c = (torch.randn(shape, generator=gen).to(BF16) for _ in range(3))
    g.view(-1)[:4] = torch.tensor([0.0, 3.0, -2.0, 1e-3]).to(BF16)
    x.view(-1)[:3] = torch.tensor([0.0, 1e-3, -1e-3]).to(BF16)
    return x, g, c


@pytest.mark.parametrize("clip", [False, True], ids=["step", "clip"])
@pytest.mark.parametrize("shape,gamma,eps", [
    ((4, 64, 9, 9), 0.02 / 255, 2.0 / 255),     # the SE tap, gamma < ulp/2
    ((4, 304, 9, 9), 1.5 / 255, 2.0 / 255),     # the SD concat feature
    ((3, 50), 0.3, 0.2), ((1001,), 0.03 / 255, 2.0 / 255)])
def test_pgd_update_bf16_is_afans_pallas_kernel_bit_for_bit(shape, gamma,
                                                            eps, clip):
    x, g, c = bf16_inputs(shape, seed=len(shape) + int(clip))
    want = pgd_update_pallas(to_jax(x), to_jax(g), to_jax(c) if clip else None,
                             gamma=gamma, eps=eps, clip=clip, interpret=True)
    got = pgd_step.pgd_update(x, g, c if clip else None, gamma=gamma,
                              eps=eps if clip else None, clip=clip)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert np.array_equal(bf16_bits(got), bf16_bits(want))
    if gamma < 1e-3 and not clip:
        moved = float((got != x).float().mean())
        print(f"{shape} gamma {gamma:.3g}: the update changed {moved:.1%} "
              f"of the entries")
        assert moved < 0.5


def test_pgd_update_bf16_rounds_gamma_and_eps_first():
    """gamma and eps are rounded to bf16 before they step, as ``afan``'s
    ``jnp.full((steps,), gamma, x.dtype)`` and weak-typed eps round them.
    At x = c = 1 + 2^-7 (an odd last bit), gamma = eps = 0.999 * 2^-8 rounds
    to 2^-8 and every sum below is a tie that goes to the even neighbour;
    unrounded, each sum would round the other way."""
    odd = 1.0 + 2.0 ** -7
    step = 0.999 * 2.0 ** -8
    x = torch.tensor([odd, 3.0, -3.0], dtype=BF16)
    g = torch.tensor([1.0, 0.0, 0.0], dtype=BF16)
    c = torch.full((3,), odd, dtype=BF16)
    for clip in (False, True):
        want = pgd_update_pallas(to_jax(x), to_jax(g),
                                 to_jax(c) if clip else None, gamma=step,
                                 eps=step if clip else None, clip=clip,
                                 interpret=True)
        got = pgd_step.pgd_update(x, g, c if clip else None, gamma=step,
                                  eps=step if clip else None, clip=clip)
        assert np.array_equal(bf16_bits(got), bf16_bits(want))
        unrounded = (x.float() + np.float32(step) * g.float())
        if clip:
            unrounded = unrounded.clamp(float(odd - np.float32(step)),
                                        float(odd + np.float32(step)))
        assert not torch.equal(got, unrounded.to(BF16))
    assert got.float().tolist() == [1.0 + 2.0 ** -6, 1.0 + 2.0 ** -6, 1.0]


@pytest.mark.parametrize("shape,focal", [
    ((2, 9, 9, 21, 33, 33), None), ((2, 9, 9, 21, 33, 33), (1.0, 2.0)),
    ((8, 8, 8, 19, 32, 32), None), ((2, 9, 7, 5, 33, 28), (1.0, 2.0))],
    ids=["voc", "voc_focal", "city_b8", "odd_focal"])
def test_plain_resize_ce_on_bf16_logits_matches_afan(shape, focal):
    b, h, w, c, H, W = shape
    rng = np.random.RandomState(b + c)
    lo = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(BF16)
    lab = rng.randint(0, c, (b, H, W)).astype(np.int32)
    lab[0, :3, :3] = 255
    g = np.linspace(0.5, 1.5, b).astype(np.float32)
    lo_j = to_jax(lo.permute(0, 2, 3, 1))
    sums_j, vjp = jax.vjp(
        lambda x: j_fused(x, jnp.asarray(lab), (H, W), True, focal), lo_j)
    (dlo_j,) = vjp(jnp.asarray(g))
    x = lo.clone().requires_grad_(True)
    sums = rce.fused_resize_nll_sums(x, torch.from_numpy(lab), (H, W), focal)
    (dlo,) = torch.autograd.grad(sums, x, torch.from_numpy(g))
    assert sums.dtype == torch.float32 and sums_j.dtype == jnp.float32
    assert dlo.dtype == BF16 and dlo_j.dtype == jnp.bfloat16
    want = np.asarray(sums_j)
    np.testing.assert_allclose(sums.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    got_d = dlo.permute(0, 2, 3, 1).float().numpy()
    want_d = np.asarray(dlo_j.astype(jnp.float32))
    ulp = np.maximum(np.abs(want_d), np.float32(2.0 ** -126)) * 2.0 ** -7
    assert (np.abs(got_d - want_d) <= ulp).all()
    print(f"{shape} focal={focal}: {int((got_d != want_d).sum())} of "
          f"{got_d.size} gradient entries one bf16 ulp apart")


def test_bf16_resize_and_pooling_are_afans():
    """``resize_bilinear`` on bf16 is ``jax.image.resize`` on bf16 bit for
    bit (bf16 weights, H then W, each contraction rounded); the image
    pooling reduces in f32 and rounds once, as ``jnp.mean``."""
    from afan.models.deeplab.heads import resize_bilinear as j_resize
    rng = np.random.RandomState(1)
    for h, w, H, W in ((9, 9, 33, 33), (3, 3, 9, 9), (5, 7, 17, 25)):
        x = torch.from_numpy(rng.randn(2, 6, h, w).astype(np.float32)).to(BF16)
        want = j_resize(to_jax(x.permute(0, 2, 3, 1)), (H, W))
        got = resize_bilinear(x, (H, W)).permute(0, 2, 3, 1).contiguous()
        assert got.dtype == BF16
        assert np.array_equal(bf16_bits(got), bf16_bits(want))
    x = torch.from_numpy(rng.randn(2, 16, 9, 9).astype(np.float32)).to(BF16)
    want = jnp.mean(to_jax(x.permute(0, 2, 3, 1)), axis=(1, 2))
    got = GlobalMean()(x)[:, :, 0, 0]
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_afn_on_bf16_matches_afan():
    """AFN's statistics reduce in f32 and return bf16, as ``jnp.mean`` and
    ``jnp.var`` do; the mix then runs in bf16 (within 2 bf16 ulps: the
    variance is summed in another order before its rounding)."""
    from afan.core.afn import mix_feature as j_mix
    rng = np.random.RandomState(2)
    clean, adv = (torch.from_numpy(rng.randn(2, 32, 5, 5).astype(np.float32)
                                   ).to(BF16) for _ in range(2))
    got = afn.mix_feature(clean, adv).permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(j_mix(to_jax(clean.permute(0, 2, 3, 1)),
                            to_jax(adv.permute(0, 2, 3, 1))
                            ).astype(jnp.float32))
    assert afn.mix_feature(clean, adv).dtype == BF16
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    assert (np.abs(got - want) <= 2 * ulp).all()


# ------------------------------------------------------------------ steps


def recipe_argv(name, **env):
    """The flags of ``recipes/<name>``'s afan command line, with its shell
    variables set to ``env`` and ``$(seg_smoke_flags)`` to its data flag."""
    with open(os.path.join(ROOT, "recipes", name)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "-m afan.cli.train_segment" in ln)
    for k, v in env.items():
        line = line.replace("${%s}" % k, v)
    line = line.replace("$(seg_smoke_flags)", "--data_root /nonexistent")
    assert "$" not in line, line
    argv = shlex.split(line)
    return argv[argv.index("afan.cli.train_segment") + 1:]


@pytest.fixture
def flax_no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)


@pytest.fixture(scope="module")
def voc_setup():
    rng = np.random.RandomState(11)
    scale = np.linspace(0.4, 1.0, B, dtype=np.float32)[:, None, None, None]
    images = (rng.rand(B, HW, HW, 3) * scale).astype(np.float32)
    labels = rng.randint(0, NC, (B, HW, HW)).astype(np.int32)
    labels[0, :5, :5] = 255
    jm = jmodeling.DeepLab(backbone_name="resnet18", num_classes=NC,
                           output_stride=16)
    init = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                        False))
    variables = jax.device_get(init(jax.random.PRNGKey(3),
                                    jnp.asarray(images)))
    return variables, images, labels


def port_model(variables, dtype):
    tm = DeepLab("resnet18", NC, 16, dtype=dtype)
    tm.load_state_dict(deeplab_variables_to_state_dict(variables))
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return tm


def rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_bf16_forward_matches_afan(voc_setup, flax_no_dropout):
    variables, images, _ = voc_setup
    x = jnp.asarray(images)
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = jmodeling.DeepLab(backbone_name="resnet18", num_classes=NC,
                               output_stride=16, dtype=dt)
        lo = jax.jit(lambda v, x: jm.apply(
            v, x, True, mutable=["batch_stats"],
            method=jm.forward_logits)[0])(variables, x)
        out[name] = np.asarray(lo.astype(jnp.float32))
    assert lo.dtype == jnp.bfloat16
    tm = port_model(variables, BF16).train()
    got = tm.forward_logits(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert got.dtype == BF16
    got = got.detach().permute(0, 2, 3, 1).float().numpy()
    port_gap, own_gap = rel_gap(got, out["bf16"]), rel_gap(out["bf16"],
                                                          out["f32"])
    print(f"os4 logits: port-vs-afan (bf16) {port_gap:.3e}; afan bf16-vs-f32 "
          f"{own_gap:.3e}")
    assert port_gap <= 2 * own_gap


def afan_step(variables, images, labels, argv, dtype):
    """afan's step that ``argv`` builds, with the model in ``dtype`` and the
    fused upsample + CE on its loss sites (interpret mode)."""
    args = j_train_segment.get_parser().parse_args(argv)
    jm = jmodeling.DeepLab(backbone_name="resnet18", num_classes=NC,
                           output_stride=16, dtype=dtype)
    tx = jloop.segmentation_tx(j_poly(LR, TOTAL), 0.9, 1e-4)
    state = TrainState.create(variables, tx)
    step = j_train_segment._build_variant_step(args, jm, tx, True)
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(1))
    return deeplab_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})), \
        float(metrics["loss"])


def test_bf16_afan_step_with_the_voc07_recipe_matches_afan(voc_setup,
                                                          flax_no_dropout):
    variables, images, labels = voc_setup
    argv = recipe_argv("seg_voc07_final1.sh", MIX="01")
    assert "--bf16" in argv and "--dataset" in argv
    j_bf16, loss_bf16 = afan_step(variables, images, labels, argv,
                                  jnp.bfloat16)
    j_f32, loss_f32 = afan_step(variables, images, labels, argv, jnp.float32)

    args = train_segment.get_parser().parse_args(argv)
    assert args.bf16 and args.lr == LR and args.total_itrs == TOTAL
    tm = port_model(variables, BF16)
    opt, sched = sgd(segmentation_param_groups(tm),
                     poly_schedule(LR, TOTAL), LR, 0.9, 1e-4)
    step = train_segment.build_step(args, tm, opt, sched)
    out = step(torch.from_numpy(images), torch.from_numpy(labels))
    loss = float(out["loss"])
    port_gap = abs(loss - loss_bf16) / abs(loss_bf16)
    own_gap = abs(loss_bf16 - loss_f32) / abs(loss_bf16)
    print(f"loss: port {loss:.6f}, afan bf16 {loss_bf16:.6f}, afan f32 "
          f"{loss_f32:.6f}; port-vs-afan {port_gap:.3e}, afan bf16-vs-f32 "
          f"{own_gap:.3e}")
    assert port_gap <= 2 * own_gap + 1e-3

    before = deeplab_variables_to_state_dict(variables)
    got = tm.state_dict()
    worst = (0.0, "")
    for k, w in j_bf16.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w, f, b = (got[k].float().numpy(), w.numpy(), j_f32[k].numpy(),
                      before[k].numpy())
        scale = max(np.linalg.norm(w - b), 1e-12)
        port = np.linalg.norm(g - w) / scale
        own = np.linalg.norm(w - f) / scale
        worst = max(worst, (port / (2 * own + 1e-3), k))
        assert port <= 2 * own + 1e-3, (k, port, own)
    print(f"updates: the largest port-vs-afan gap over its bound is "
          f"{worst[0]:.3f} of it ({worst[1]})")


def test_sd_noise_is_drawn_in_float32(monkeypatch, voc_setup):
    """``afan``'s ``uniform_init`` draws the SD noise in its default
    float32 whatever the feature's dtype, and the sum promotes to
    float32."""
    variables, images, labels = voc_setup
    drawn = []

    def recording(shape, scale, generator=None, dtype=torch.float32,
                  device=None):
        drawn.append(dtype)
        return attack.uniform_init(shape, scale, generator, dtype, device)
    monkeypatch.setattr(segment_loop, "uniform_init", recording)
    tm = port_model(variables, BF16)
    opt, sched = sgd(segmentation_param_groups(tm), poly_schedule(LR, TOTAL),
                     LR, 0.9, 1e-4)
    cfg = segment_loop.SegAfanConfig(sd="aspp", noise_sd=1.0)
    out = segment_loop.make_afan_seg_step(tm, opt, sched, cfg)(
        torch.from_numpy(images[:2]), torch.from_numpy(labels[:2]))
    assert drawn == [torch.float32] and np.isfinite(float(out["loss"]))
