"""``random_steps`` with the step sizes on the device: the port's ALFA
device-data step against ``afan``'s ``make_alfa_step(random_steps=True)``,
and the plain PGD update with a tensor step size against a Python one.

``afan`` draws its step sizes as ``2 * gamma * uniform(fold_in(rng,
0x57C4), (steps,), x.dtype)`` (`afan/core/attack.py:108-113`); the port
draws its own on the device (:func:`afan_torch.core.attack.random_step_sizes`).
The two frameworks' draws never match, so the test computes ``afan``'s
step sizes from the key it gives ``afan``'s step and hands them to the
port's step as the step-size tensor, the way the port's own draws reach
the PGD update. In the device-data step the batch is gathered and augmented
on the device (32x32 CIFAR images) and ``afan``'s step gets the same
augmented images; the host-data step runs on
``tests/test_torch_classify.py``'s 16x16 batches.

Tolerances, as ``tests/test_torch_classify.py``: loss, accuracy and the
perturbation norms within 1e-4 relative (the norms plus what sign flips of
near-zero gradients add); after the host-data steps every parameter,
running statistic and momentum buffer within 1e-4 of its norm. (At 32x32
the BatchNorm biases' momentum, a sum over four times the pixels, drifts
from ``afan``'s by up to 3e-4 of its norm with fixed step sizes too, so the
device-data test holds the step's outputs only.) The tensor-step plain
update equals the Python-step one bit for bit, float32 and bfloat16, NaN
included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.train import loop as jloop
from afan.train import optim as joptim
from afan_torch.core import attack
from afan_torch.core.project import weak_scalar
from afan_torch.data import cifar
from afan_torch.interop.from_jax import resnet_s_variables_to_state_dict
from afan_torch.models.resnet_s import ResNetS
from afan_torch.ops.pgd_step import pgd_update, pgd_update_plain
from afan_torch.train import loop, optim
from test_torch_classify import (BLOCKS, LR, MOMENTUM, NC, WD, batch,
                                 check_ascents, close, compare_states,
                                 recorded, schedules, variables)
from torch_threads import one_torch_thread  # noqa: F401

B, N, STEPS = 8, 24, 2
PORT_STEP_SIZES = attack.random_step_sizes


def split():
    """32x32 uint8 images with class-dependent means (the device-data step
    crops 32x32 out of the image padded by 4)."""
    rng = np.random.RandomState(5)
    y = rng.randint(0, NC, N)
    x = np.clip(rng.rand(N, 32, 32, 3) * 0.1 + y[:, None, None, None] * 0.25,
                0, 1)
    return (torch.from_numpy((x * 255).astype(np.uint8)),
            torch.from_numpy(y.astype(np.int64)))


def afan_step_sizes(key, gamma):
    """``afan``'s step sizes for the PGD of a step given ``key``."""
    return np.array(2.0 * gamma * jax.random.uniform(
        jax.random.fold_in(key, 0x57C4), (STEPS,), jnp.float32))


def both_steps(variables, device_data):
    """afan's jitted random-steps ALFA step and the port's, from the same
    weights; returns (jstep, state, tstep, model, optimizer, gamma)."""
    jm, vs = variables
    jsched, tsched = schedules()
    tm = ResNetS(BLOCKS, NC, 1.0 / 9)
    tm.load_state_dict(resnet_s_variables_to_state_dict(vs), strict=True)
    tx = joptim.sgd(jsched, MOMENTUM, WD)
    opt, sched = optim.sgd([{"params": list(tm.parameters())}], tsched, LR,
                           MOMENTUM, WD)
    jcfg = jloop.AlfaConfig(tap=5, steps=STEPS, random_steps=True)
    tcfg = loop.AlfaConfig(tap=5, steps=STEPS, random_steps=True)
    tstep = (loop.make_device_data_alfa_step(tm, opt, sched, tcfg, B,
                                             record_augment=True)
             if device_data else loop.make_alfa_step(tm, opt, sched, tcfg))
    return (jloop.make_alfa_step(jm, tx, jcfg),
            jloop.TrainState.create(vs, tx), tstep, tm, opt, jcfg.gamma)


def inject(monkeypatch, sizes, drawn):
    """The port's step sizes replaced by ``sizes``; its own draws go to
    ``drawn``."""
    def afans(gamma, steps, generator, dtype, device):
        ours = PORT_STEP_SIZES(gamma, steps, generator, dtype, device)
        assert ours.shape == (steps,) and ours.dtype == dtype
        drawn.append(ours)
        return torch.from_numpy(sizes).to(device)

    monkeypatch.setattr(attack, "random_step_sizes", afans)


def check_outputs(out, jm_out, rec, sizes, i):
    for k in ("loss", "accuracy"):
        close(float(out[k]), float(jm_out[k]), msg=f"step {i} {k}")
    check_ascents(rec, float(sizes.min()), out["pert_l2"].numpy(),
                  out["pert_linf"].numpy(), np.asarray(jm_out["pert_l2"]),
                  np.asarray(jm_out["pert_linf"]))


def test_alfa_random_steps_hold_afans_with_its_step_sizes(
        variables, recorded, monkeypatch):
    """Host data: two steps, then the whole training state."""
    jstep, state, tstep, tm, opt, gamma = both_steps(variables, False)
    gen = torch.Generator().manual_seed(3)
    drawn = []
    for i in range(2):
        key = jax.random.PRNGKey(i)
        sizes = afan_step_sizes(key, gamma)
        inject(monkeypatch, sizes, drawn)
        x, y = batch(i + 1)
        state, jm_out = jstep(state, jnp.asarray(x), jnp.asarray(y), key)
        out = tstep(torch.from_numpy(x), torch.from_numpy(y), gen)
        check_outputs(out, jm_out, recorded, sizes, i)
    compare_states(tm, opt, state)
    # the port's own draws: in (0, 2 gamma), new at each step
    assert len(drawn) == 2 and not torch.equal(drawn[0], drawn[1])
    for d in drawn:
        assert (d > 0).all() and (d < 2 * gamma).all()


def test_device_data_alfa_random_steps_hold_afans(variables, recorded,
                                                  monkeypatch):
    """Device data: the batch gathered from the permutation and augmented
    by the port's step, ``afan``'s step on the same images; two steps."""
    jstep, state, tstep, _, _, gamma = both_steps(variables, True)
    data_x, data_y = split()
    gen = torch.Generator().manual_seed(3)
    perm = torch.randperm(N, generator=gen)
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        sizes = afan_step_sizes(key, gamma)
        inject(monkeypatch, sizes, [])
        out = tstep(data_x, data_y, perm, i, gen)
        idx = cifar.batch_indices(perm, torch.tensor(i), B)
        x = cifar.apply_augment(data_x[idx], out["crop"], out["flip"])
        state, jm_out = jstep(state, jnp.asarray(x.numpy()),
                              jnp.asarray(data_y[idx].numpy()), key)
        check_outputs(out, jm_out, recorded, sizes, i)


@pytest.mark.parametrize("clip", [False, True], ids=["step", "clip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_update_with_a_tensor_step_size_equals_a_number(dtype, clip):
    """The step sizes are ``weak_scalar``'s roundings of ``2 * gamma * u``
    (float64 to the dtype), and the plain update with one of them as a
    one-element tensor equals it with the Python number, bit for bit."""
    gen = torch.Generator().manual_seed(11)
    shape = (4, 16, 9, 9)
    x, g, c = (torch.randn(shape, generator=gen).to(dtype) for _ in range(3))
    flat = g.view(-1)
    flat[:8] = torch.tensor([0.0, -0.0, 1e-40, -1e-40, float("nan"),
                             float("inf"), -float("inf"), 1e-45]).to(dtype)
    gamma, eps, steps = 0.02 / 255, 2.0 / 255, 6
    sizes = attack.random_step_sizes(gamma, steps,
                                     torch.Generator().manual_seed(4), dtype,
                                     "cpu")
    u = torch.rand((steps,), generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64)
    want_sizes = [weak_scalar(s, dtype) for s in (2.0 * gamma * u).tolist()]
    assert sizes.dtype == dtype and sizes.tolist() == want_sizes
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for t in range(steps):
        kw = dict(eps=eps if clip else None, clip=clip)
        got = pgd_update(x, g, c if clip else None, gamma=sizes[t:t + 1],
                         **kw)
        want = pgd_update_plain(x, g, c if clip else None,
                                gamma=want_sizes[t], **kw)
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got.view(bits), want.view(bits)), t
