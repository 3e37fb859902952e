"""afan_torch's ``--epoch_scan`` slice on the CPU: the device-tensor lr
schedule and the capturable SGD against the host schedule, ``torch.optim.SGD``
and ``afan``'s optax SGD; the device-index batch gather against ``afan``'s
``dynamic_slice``; the epoch scan against the eager device-data steps, bit for
bit; and the CLI's ``--epoch_scan`` with a resume.

On the CPU the epoch scan runs its step body eagerly at every step; the CUDA
graph of the same body is held to the eager steps on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). The model is
``ResNetS(num_blocks=(1, 1, 1), num_classes=4)`` on a 64-image uint8 split
at batch 16, as ``tests/test_fast_paths.py:TestEpochScan`` runs ``afan``'s.

Tolerances: the schedule equals the port's host schedule exactly (the same
float64 operations) and ``afan``'s float32 one within 1e-6 relative; the
capturable SGD's parameters and momentum buffers agree with
``torch.optim.SGD``'s and optax's within 1e-6 of each tensor's largest
value (its ``p -= lr * t`` rounds the product before the difference, which
``SGD`` fuses, and optax's lr is float32 arithmetic).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from afan.models.resnet_s import ResNetS as JResNetS
from afan.train import loop as jloop
from afan.train import optim as joptim
from afan_torch.cli import train_classify
from afan_torch.data import cifar
from afan_torch.models.resnet_s import ResNetS
from afan_torch.train import loop, optim
from afan_torch.train.checkpoint import load_training_state
from torch_threads import one_torch_thread  # noqa: F401

BLOCKS, NC, B, STEPS, N = (1, 1, 1), 4, 16, 4, 64
LR, MOMENTUM, WD = 0.1, 0.9, 5e-4
REL = 1e-6


def close(got, want, rel=REL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (msg, err)


def split():
    """tests/test_fast_paths.py:TestEpochScan's data: class-dependent
    means, as uint8."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, NC, N)
    x = np.clip(rng.rand(N, 32, 32, 3) * 0.1 + y[:, None, None, None] * 0.25,
                0, 1)
    return (torch.from_numpy((x * 255).astype(np.uint8)),
            torch.from_numpy(y.astype(np.int64)))


def schedule_pair(milestones=(6, 9), warmup=4):
    return (optim.multistep_warmup_schedule(LR, milestones, 0.1, warmup),
            optim.multistep_warmup_schedule_tensor(LR, milestones, 0.1,
                                                   warmup))


def tiny_model():
    return ResNetS(BLOCKS, NC, generator=torch.Generator().manual_seed(0))


def capturable(model, milestones=(6, 9), warmup=4):
    return optim.capturable_sgd(list(model.parameters()),
                                schedule_pair(milestones, warmup)[1], LR,
                                MOMENTUM, WD)


def test_device_schedule_equals_host_and_afan_at_every_count():
    host, dev = schedule_pair((100, 200), 10)
    counts = torch.arange(0, 260, dtype=torch.int64)
    got = dev(counts)
    assert got.dtype == torch.float64
    want = [host(int(c)) for c in counts]
    assert got.tolist() == want                       # bit for bit
    for c in counts:
        assert float(dev(c)) == host(int(c))          # 0-d counts too
    jsched = joptim.multistep_warmup_schedule(LR, [100, 200], 0.1,
                                              warmup_steps=10)
    close(got.to(torch.float32).numpy(),
          np.array([float(jsched(int(c))) for c in counts]), msg="afan")
    assert got[0] == 0.0 and got[9] == pytest.approx(LR)
    assert got[150] == pytest.approx(0.01)


def grads(shapes, steps, seed=3):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) for s in shapes]
            for _ in range(steps)]


def test_capturable_sgd_equals_torch_sgd_and_optax():
    shapes = [(3, 4), (5,), (2, 3, 3)]
    rng = np.random.RandomState(1)
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = grads(shapes, 12)
    host, dev = schedule_pair()
    ours = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    theirs = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt, sched = optim.capturable_sgd(ours, dev, LR, MOMENTUM, WD)
    topt, tsched = optim.sgd([{"params": theirs}], host, LR, MOMENTUM, WD)
    tx = joptim.sgd(joptim.multistep_warmup_schedule(LR, [6, 9], 0.1, 4),
                    MOMENTUM, WD)
    jparams = [jnp.asarray(a) for a in init]
    jstate = tx.init(jparams)
    for step, g in enumerate(gs):
        for p, q, a in zip(ours, theirs, g):
            p.grad, q.grad = torch.from_numpy(a), torch.from_numpy(a)
        opt.step()
        sched.step()
        topt.step()
        tsched.step()
        upd, jstate = tx.update([jnp.asarray(a) for a in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for i, (p, q, j) in enumerate(zip(ours, theirs, jparams)):
            close(p.detach().numpy(), q.detach().numpy(), msg=(step, i))
            close(p.detach().numpy(), np.asarray(j), msg=(step, i, "optax"))
            close(opt.state[p]["momentum_buffer"].numpy(),
                  topt.state[q]["momentum_buffer"].numpy(), msg=(step, i))
    assert int(opt.count) == 12 and tsched.last_epoch == 12


def test_capturable_sgd_state_dict_round_trips_with_torch_sgd():
    shapes = [(4, 3), (6,)]
    gs = grads(shapes, 6, seed=5)
    host, dev = schedule_pair()
    make = [torch.nn.Parameter(torch.ones(s)) for s in shapes]
    opt, sched = optim.capturable_sgd(make, dev, LR, MOMENTUM, WD)
    for g in gs[:3]:
        for p, a in zip(make, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        sched.step()
    # deep copies, as a checkpoint file would hold: a loaded state_dict
    # keeps the tensors it is given
    saved_opt = copy.deepcopy(opt.state_dict())
    saved_sched = sched.state_dict()
    assert saved_opt["param_groups"][0]["lr"] == host(3)
    assert saved_sched["last_epoch"] == 3
    # into torch.optim.SGD + LambdaLR, and back into a CapturableSGD
    theirs = [torch.nn.Parameter(p.detach().clone()) for p in make]
    topt, tsched = optim.sgd([{"params": theirs}], host, LR, MOMENTUM, WD)
    topt.load_state_dict(saved_opt)
    tsched.load_state_dict(saved_sched)
    back = [torch.nn.Parameter(p.detach().clone()) for p in make]
    bopt, bsched = optim.capturable_sgd(back, dev, LR, MOMENTUM, WD)
    bopt.load_state_dict(copy.deepcopy(topt.state_dict()))
    bsched.load_state_dict(tsched.state_dict())
    assert int(bopt.count) == 3
    for g in gs[3:]:
        for p, q, r, a in zip(make, theirs, back, g):
            p.grad = q.grad = r.grad = torch.from_numpy(a)
        for o, s in ((opt, sched), (topt, tsched), (bopt, bsched)):
            o.step()
            s.step()
    for p, q, r in zip(make, theirs, back):
        close(q.detach().numpy(), p.detach().numpy(), msg="torch SGD")
        assert torch.equal(r, p)
    assert int(bopt.count) == 6 and tsched.last_epoch == 6


def test_batch_indices_equal_afan_dynamic_slice():
    perm = np.random.RandomState(2).permutation(N)
    for i in range(N // B + 2):               # the last two are clamped
        want = jax.lax.dynamic_slice(jnp.asarray(perm), (i * B,), (B,))
        got = cifar.batch_indices(torch.from_numpy(perm), torch.tensor(i), B)
        assert np.array_equal(got.numpy(), np.asarray(want)), i


def run_eager_and_scan(epochs, record_augment=False, random_steps=False):
    data_x, data_y = split()
    cfg = loop.AlfaConfig(tap=5, steps=2, random_steps=random_steps)
    m1, m2 = tiny_model(), tiny_model()
    o1, _ = capturable(m1)
    o2, s2 = capturable(m2)
    scan = loop.make_epoch_scan_alfa(m1, o1, cfg, B, STEPS,
                                     record_augment=record_augment)
    eager = loop.make_device_data_alfa_step(m2, o2, s2, cfg, B,
                                            record_augment=record_augment)
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    out = []
    for _ in range(epochs):
        em = scan(data_x, data_y, torch.randperm(N, generator=g1), g1)
        perm = torch.randperm(N, generator=g2)
        steps = [eager(data_x, data_y, perm, i, g2) for i in range(STEPS)]
        out.append((em, steps))
    return (m1, o1, scan), (m2, o2), out


def test_epoch_scan_equals_eager_device_data_steps_bit_for_bit():
    (m1, o1, scan), (m2, o2), out = run_eager_and_scan(2, True)
    for em, steps in out:
        for k, v in em.items():
            assert torch.equal(v, torch.stack([s[k] for s in steps])), k
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(o1.state[p]["momentum_buffer"],
                           o2.state[q]["momentum_buffer"])
    assert int(o1.count) == int(o2.count) == 2 * STEPS
    assert scan.graph is None and scan.replays == 0    # eager on the CPU
    crops = torch.cat([em["crop"] for em, _ in out])
    assert crops.min() >= 0 and crops.max() <= 8


def test_epoch_scan_counts_steps_and_stacks_afan_metrics():
    data_x, data_y = split()
    model = tiny_model()
    opt, _ = capturable(model)
    scan = loop.make_epoch_scan_alfa(model, opt, loop.AlfaConfig(tap=5,
                                                                 steps=1),
                                     B, STEPS)
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        em = scan(data_x, data_y, torch.randperm(N, generator=gen), gen)
    assert int(opt.count) == 16                 # 4 epochs x 4 steps
    # afan's keys and shapes, from its own epoch scan (traced, not run)
    jm = JResNetS(num_blocks=BLOCKS, num_classes=NC)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), 0, None,
                 False)
    tx = joptim.sgd(lambda c: 0.05, 0.9)
    jfn = jloop.make_epoch_scan_alfa(jm, tx, jloop.AlfaConfig(tap=5, steps=1),
                                     B, STEPS)
    _, jem = jax.eval_shape(jfn, jloop.TrainState.create(vs, tx),
                            jnp.asarray(data_x.numpy()),
                            jnp.asarray(data_y.numpy()), jnp.arange(N),
                            jax.random.PRNGKey(1))
    assert set(em) == set(jem)
    for k, v in em.items():
        assert tuple(v.shape) == tuple(jem[k].shape) == (STEPS,), k
        assert torch.isfinite(v).all(), k
    with pytest.raises(ValueError, match="first call"):
        scan(data_x.clone(), data_y, torch.randperm(N, generator=gen), gen)


def test_epoch_scan_refuses_random_steps_and_a_host_lr_optimizer():
    """Random step sizes are drawn and rounded on the device, so an epoch
    scan takes them: its epochs equal the eager device-data steps bit for
    bit. An optimizer whose lr lives on the host is still refused."""
    (m1, _, scan), (m2, _), out = run_eager_and_scan(2, random_steps=True)
    for em, steps in out:
        for k, v in em.items():
            assert torch.equal(v, torch.stack([s[k] for s in steps])), k
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    model = tiny_model()
    topt, _ = optim.sgd([{"params": list(model.parameters())}],
                        lambda c: LR, LR)
    with pytest.raises(TypeError, match="CapturableSGD"):
        loop.make_epoch_scan_alfa(model, topt, loop.AlfaConfig(), B, STEPS)


def small_loaders(train_batch_size, test_batch_size, data_dir, seed):
    """A 48 / 16 / 16 split of the synthetic CIFAR, as
    tests/test_torch_classify.py: validation takes seconds on the CPU."""
    tx, ty, ex, ey = cifar.synthetic_arrays(64, 16, 10, seed)
    return (cifar.CifarLoader(tx[:48], ty[:48], train_batch_size, True, seed),
            cifar.CifarLoader(tx[48:], ty[48:], test_batch_size, False),
            cifar.CifarLoader(ex, ey, test_batch_size, False))


def test_cli_epoch_scan_on_cpu_then_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(train_classify, "cifar10_dataloaders", small_loaders)
    d = str(tmp_path)
    argv = ["--device", "cpu", "--mode", "alfa", "--epoch_scan",
            "--limit_batches", "2", "--batch_size", "8", "--steps", "1",
            "--decreasing_lr", "1,3", "--data", "/nonexistent",
            "--save_dir", d]
    # 6 steps per epoch at batch 8: warmup over the first epoch's 2 steps
    host = optim.multistep_warmup_schedule(LR, [2, 6], 0.1, warmup_steps=2)
    train_classify.main(argv + ["--epochs", "2"])
    saved = load_training_state(os.path.join(d, "checkpoint.pt"))
    assert saved["epoch"] == 2 and saved["step"] == 4
    assert saved["scheduler"]["last_epoch"] == 4
    assert saved["optimizer"]["param_groups"][0]["lr"] == host(4)
    logs = []
    monkeypatch.setattr(train_classify.Log, "i", logs.append)
    train_classify.main(argv + ["--epochs", "3", "--resume"])
    assert any("optimizer state restored" in m for m in logs)
    resumed = load_training_state(os.path.join(d, "checkpoint.pt"))
    assert resumed["epoch"] == 3 and resumed["step"] == 6
    assert resumed["scheduler"]["last_epoch"] == 6     # 4 restored + 2
    assert resumed["optimizer"]["param_groups"][0]["lr"] == host(6)
    assert all(bool(torch.isfinite(v).all())
               for v in resumed["state_dict"].values()
               if v.is_floating_point())
