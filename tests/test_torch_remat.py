"""Recomputation in afan_torch (``--backbone_remat``, ``--remat_tails``)
against afan's ``nn.remat`` / ``jax.checkpoint``, and against the port's
own steps without recomputation.

- ``ResNetTorso(remat=True)`` and ``remat=(1, 1, 0, 0)`` with trainable
  BatchNorm: the forward, the gradients of the parameters and of the input,
  and the running statistics against ``afan``'s torso with the same
  ``remat``; against the port's torso without it, bit for bit.
- The segmentation A-FAN step with ``backbone_remat``, ``remat_tails`` and
  both (``tests/test_torch_segment.py``'s model, batch and tolerances)
  against ``afan``'s step with the same config; against the port's step
  without recomputation bit for bit: losses, parameters and running
  statistics, so the recompute applies no second EMA. One more pair keeps
  the decoder's dropout on, whose masks the recompute must draw again from
  the default generator's state at the forward.
- The wrapper alone: one EMA, the explicit generator's draw replayed and
  its state kept, nothing recorded under ``no_grad``.

The detection step's recomputation is tested in
``tests/test_torch_remat_detect.py``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.models.deeplab import modeling as jmodeling
from afan.models.resnet import from_name as j_resnet
from afan.train import segment_loop as j_segment_loop
from afan_torch.interop.from_jax import deeplab_variables_to_state_dict
from afan_torch.models.deeplab import DeepLab
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.models.resnet import BatchNorm, from_name
from afan_torch.train import segment_loop
from afan_torch.train.optim import poly_schedule, sgd
from afan_torch.train.remat import remat

import test_torch_segment as seg
from test_torch_segment import flax_no_dropout, setup  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def state_equal(a, b):
    """Two state dicts equal bit for bit."""
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------- the wrapper ----------

def test_remat_keeps_generators_and_running_statistics():
    """A region that updates BatchNorm statistics and draws from an
    explicit generator: one EMA, the forward's draw in the recompute, the
    generator left where the step took it, and the gradients of the region
    without recomputation; under ``no_grad`` only the function runs."""
    torch.manual_seed(0)
    bn = BatchNorm(3)
    x = torch.randn(4, 3, 5, 5, requires_grad=True)

    def region(x, g):
        return bn(x) * torch.rand(x.shape, generator=g)

    grads, stats, states = [], [], []
    for recompute in (False, True):
        bn.reset_running_stats()
        g = torch.Generator().manual_seed(5)
        y = (remat(region, x, g, module=bn, generators=(g, None))
             if recompute else region(x, g))
        after = g.get_state()
        torch.rand(7, generator=g)          # the step goes on drawing
        reached = g.get_state()
        grads.append(torch.autograd.grad((y * y).sum(), x)[0])
        states.append((after, g.get_state(), reached))
        stats.append((bn.running_mean.clone(), bn.running_var.clone()))
    assert torch.equal(grads[0], grads[1])
    assert all(torch.equal(a, b) for a, b in zip(*stats))
    assert torch.equal(states[1][1], states[1][2])
    assert torch.equal(states[0][0], states[1][0])
    with torch.no_grad():
        out = remat(lambda t: t + 1, x, module=bn)
    assert not out.requires_grad


# ---------- the torso ----------

@pytest.mark.parametrize("mask", [True, (1, 1, 0, 0)], ids=["all", "1100"])
def test_torso_remat_matches_afan(mask):
    jt = j_resnet("resnet18", output_stride=16, frozen_bn=False,
                  bn_momentum=0.99, remat=mask)
    rng = np.random.RandomState(3)
    # entries of different brightness (tests/test_torch_deeplab.py:batch)
    x = (rng.rand(2, 33, 33, 3)
         * np.linspace(0.4, 1.0, 2)[:, None, None, None]).astype(np.float32)
    variables = jax.device_get(jt.init(jax.random.PRNGKey(3),
                                       jnp.asarray(x)))
    probe = rng.randn(2, 3, 3, 512).astype(np.float32)

    def j_loss(params, xin):
        out, upd = jt.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            xin, 0, 4, True, mutable=["batch_stats"])
        return jnp.sum(out * probe), (out, upd["batch_stats"])

    (_, (want, want_stats)), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                               jnp.asarray(x))

    def tree_to_torch(tree):
        sd = deeplab_variables_to_state_dict(
            {c: {"backbone": tree[c]} for c in tree})
        return {k[len("backbone."):]: v for k, v in sd.items()}

    got = {}
    for r in (mask, False):
        tt = from_name("resnet18", output_stride=16, norm=BatchNorm,
                       remat=r)
        tt.load_state_dict(tree_to_torch(variables))
        tt.train()
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        out = tt(xt)
        (out * torch.from_numpy(probe).permute(0, 3, 1, 2)).sum().backward()
        got[r] = (out.detach(), xt.grad,
                  {n: p.grad for n, p in tt.named_parameters()},
                  copy.deepcopy(tt.state_dict()))
    (out, gx, gp, state), plain = got[mask], got[False]
    assert torch.equal(out, plain[0]) and torch.equal(gx, plain[1])
    assert all(torch.equal(gp[n], plain[2][n]) for n in gp)
    state_equal(state, plain[3])
    seg.close(out.permute(0, 2, 3, 1).numpy(), want, msg="output")
    seg.close(gx.permute(0, 2, 3, 1).numpy(), want_gx, msg="input gradient")
    want_grads = tree_to_torch({"params": want_gp})
    for n, g in gp.items():
        seg.close(g.numpy(), want_grads[n].numpy(), msg=n)
    want_state = tree_to_torch({"params": variables["params"],
                                "batch_stats": want_stats})
    for k in ("running_mean", "running_var"):
        for name, v in state.items():
            if name.endswith(k):
                seg.close_l2(v.numpy(), want_state[name].numpy(), 1e-4, name)


# ---------- the segmentation step ----------

SEG_KW = dict(tap_se=2, sd="concat", spectrum=3, mix_mask=(0, 0, 1),
              mix_sd=True)


def seg_port(variables, backbone_remat, dropout=False):
    tm = DeepLab("resnet18", seg.NC, 16, backbone_remat=backbone_remat)
    tm.load_state_dict(deeplab_variables_to_state_dict(variables))
    if not dropout:
        for m in tm.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    opt, sched = sgd(segmentation_param_groups(tm),
                     poly_schedule(seg.LR, seg.TOTAL), seg.LR, 0.9, 1e-4)
    return tm, opt, sched


def seg_port_step(setup, backbone_remat, remat_tails, dropout=False):
    _, variables, images, labels = setup
    tm, opt, sched = seg_port(variables, backbone_remat, dropout)
    torch.manual_seed(4)
    out = segment_loop.make_afan_seg_step(
        tm, opt, sched, segment_loop.SegAfanConfig(
            remat_tails=remat_tails, **SEG_KW))(
        torch.from_numpy(images), torch.from_numpy(labels))
    return tm, out


@pytest.fixture(scope="module")
def seg_plain(setup):
    return seg_port_step(setup, False, False)


@pytest.mark.parametrize("backbone_remat,remat_tails",
                         [(True, False), (False, True), (True, True)],
                         ids=["backbone_remat", "remat_tails", "both"])
def test_seg_afan_step(setup, seg_plain, flax_no_dropout, backbone_remat,
                       remat_tails):
    jm, variables, images, labels = setup
    jm = jmodeling.DeepLab(backbone_name="resnet18", num_classes=seg.NC,
                           output_stride=16, backbone_remat=backbone_remat)
    state, tx = seg.jax_state(variables)
    step = j_segment_loop.make_afan_seg_step(
        jm, tx, j_segment_loop.SegAfanConfig(
            fused_ce=False, remat_tails=remat_tails, **SEG_KW))
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(1))
    tm, out = seg_port_step(setup, backbone_remat, remat_tails)
    plain_tm, plain_out = seg_plain
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        assert torch.equal(out[k], plain_out[k]), k
        seg.close(float(out[k]), float(metrics[k]), msg=k)
    state_equal(tm.state_dict(), plain_tm.state_dict())
    seg.compare_states(tm, variables, state)


def test_seg_step_with_dropout_draws_the_forwards_masks(setup):
    """Both flags with the decoder's dropout on: the recompute draws the
    forward's masks, so the step is the plain one bit for bit."""
    tm, out = seg_port_step(setup, True, True, dropout=True)
    plain_tm, plain_out = seg_port_step(setup, False, False, dropout=True)
    for k in out:
        assert torch.equal(out[k], plain_out[k]), k
    state_equal(tm.state_dict(), plain_tm.state_dict())
