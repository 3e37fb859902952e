"""afan_torch's classification trainer against afan's: one base, one ALFA
(tap 5, 2 PGD steps) and one learnable-η step (taps (2, 5, 7), 1 step), each
run twice from the same weights and batches; the schedule; the CIFAR data
path; the checkpoint round trip; and the CLIs on the CPU.

The model is ``ResNetS(num_blocks=(1, 1, 1), num_classes=4)`` on 16x16
inputs at batch 8, as ``tests/test_train.py``, with weights carried by
``resnet_s_variables_to_state_dict``; ``afan``'s steps are its jitted ones.

Tolerance: losses, accuracy and perturbation norms within 1e-4 relative;
every updated parameter (``w`` included), running statistic and SGD
momentum buffer within 1e-4 of its norm. Tensors are compared by norm, as
in ``tests/test_torch_segment.py``: a pre-activation within float noise of
zero can take the other side of a ReLU in the other framework.

Sign flips: the ascent steps by ``gamma * sign(g)``, and where ``g`` is
within float noise of zero the two frameworks can take opposite signs, which
moves that element by 2 gamma. The tests capture both sides' adversarial
features and allow at most ``FLIP_FRACTION`` of the elements to differ by
such a step; the perturbation norms then get, on top of the 1e-4, exactly
the difference those flips make (the norm of the difference of the two
perturbations, which bounds the difference of their norms).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from afan.core import attack as jattack
from afan.data import cifar as jcifar
from afan.interop.torch_ckpt import load_torch_resnet_s
from afan.models.resnet_s import ResNetS as JResNetS
from afan.train import loop as jloop
from afan.train import optim as joptim
from afan_torch.cli import infer_classify, train_classify
from afan_torch.data import cifar
from afan_torch.interop.from_jax import resnet_s_variables_to_state_dict
from afan_torch.models.resnet_s import ResNetS
from afan_torch.train import loop, optim
from afan_torch.train.checkpoint import (load_training_state,
                                         save_classify_checkpoint)

BLOCKS, NC, B = (1, 1, 1), 4, 8
LR, MILESTONE, WD, MOMENTUM, W_LR = 0.1, 1, 5e-4, 0.9, 0.01
REL = 1e-4
FLIP_FRACTION = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port: its small ops run no slower on one,
    and the suite's parallel workers would otherwise oversubscribe the cores
    (the CLI test's full-width ResNet-56 slowed fifty-fold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch(seed):
    """tests/test_train.py:tiny_batch: class-dependent means."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, NC, B)
    x = rng.rand(B, 16, 16, 3) * 0.1 + y[:, None, None, None] * 0.25
    return x.astype(np.float32), y.astype(np.int64)


@pytest.fixture(scope="module")
def variables():
    jm = JResNetS(num_blocks=BLOCKS, num_classes=NC, init_weight=1.0 / 9)
    x, _ = batch(0)
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                      0, None, False))


def schedules():
    """lr 0.1 at the first update, 0.01 after the milestone."""
    return (joptim.multistep_warmup_schedule(LR, [MILESTONE]),
            optim.multistep_warmup_schedule(LR, [MILESTONE]))


def close(got, want, rel=REL, atol=0.0, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + atol, (msg, err)


def close_l2(got, want, rel=REL, msg=""):
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert err <= rel, (msg, err)


def traces(opt_state):
    """Every momentum trace of an optax state, merged into one params-shaped
    tree (masked-out leaves of a multi_transform carry no leaves)."""
    flat = {}
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState)):
        if isinstance(s, optax.TraceState):
            for path, v in jax.tree_util.tree_flatten_with_path(s.trace)[0]:
                flat[tuple(p.key for p in path)] = np.asarray(v)
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def compare_states(tm, opt, state):
    want = resnet_s_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    got = tm.state_dict()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            close_l2(got[k].numpy(), w.numpy(), msg=k)
    want_m = resnet_s_variables_to_state_dict(
        {"params": traces(state.opt_state)})
    params = dict(tm.named_parameters())
    assert set(want_m) == set(params)
    for k, w in want_m.items():
        got_m = opt.state[params[k]]["momentum_buffer"]
        close_l2(got_m.numpy(), w.numpy(), msg=f"momentum of {k}")


@pytest.fixture
def recorded(monkeypatch):
    """Capture every ascent's (clean feature, adversarial feature) on both
    sides: afan's through a debug callback inside its jitted step."""
    rec = {"afan": {}, "port": []}
    real_j, real_t = jattack.pgd, loop.pgd
    calls = [0]

    def jpgd(loss_fn, x, **kw):
        out = real_j(loss_fn, x, **kw)
        idx = calls[0]
        calls[0] += 1
        jax.debug.callback(
            lambda a, b, idx=idx: rec["afan"].__setitem__(
                idx, (np.asarray(a), np.asarray(b))), x, out)
        return out

    def tpgd(loss_fn, x, **kw):
        out = real_t(loss_fn, x, **kw)
        rec["port"].append((x.numpy(), out.numpy()))
        return out

    monkeypatch.setattr(jloop, "pgd", jpgd)
    monkeypatch.setattr(loop, "pgd", tpgd)
    return rec


def check_ascents(rec, gamma, pert_l2, pert_linf, want_l2, want_linf):
    """Flip allowance, then the norms within 1e-4 plus what flips add."""
    pairs = [rec["afan"][i] for i in sorted(rec["afan"])]
    assert len(pairs) == len(rec["port"])
    pert_l2, pert_linf = np.atleast_1d(pert_l2), np.atleast_1d(pert_linf)
    want_l2, want_linf = np.atleast_1d(want_l2), np.atleast_1d(want_linf)
    for i, ((ja, jb), (ta, tb)) in enumerate(zip(pairs, rec["port"])):
        if ja.ndim == 4:
            ja, jb = ja.transpose(0, 3, 1, 2), jb.transpose(0, 3, 1, 2)
        flips = np.abs(tb - jb) > gamma / 2
        assert flips.mean() <= FLIP_FRACTION, (i, flips.mean())
        diff = ((tb - ta) - (jb - ja)).reshape(len(ta), -1)
        l2_slack = np.linalg.norm(diff, axis=1).mean()
        linf_slack = np.abs(diff).max(axis=1).mean()
        close(pert_l2[i], want_l2[i], atol=l2_slack, msg=f"pert_l2 {i}")
        close(pert_linf[i], want_linf[i], atol=linf_slack,
              msg=f"pert_linf {i}")
    rec["afan"].clear()
    rec["port"].clear()


def run_both(variables, mode, rec=None):
    jm, vs = variables
    jsched, tsched = schedules()
    tm = ResNetS(BLOCKS, NC, 1.0 / 9)
    tm.load_state_dict(resnet_s_variables_to_state_dict(vs), strict=True)
    if mode == "learnable":
        tx = joptim.learnable_tx(jsched, W_LR, MOMENTUM, WD)
        opt, sched = optim.learnable_sgd(tm, tsched, LR, W_LR, MOMENTUM, WD)
        jcfg = jloop.LearnableConfig(taps=(2, 5, 7), steps=1)
        tcfg = loop.LearnableConfig(taps=(2, 5, 7), steps=1)
        jstep = jloop.make_learnable_step(jm, tx, jcfg)
        tstep = loop.make_learnable_step(tm, opt, sched, tcfg)
        gamma = jcfg.gamma
    else:
        tx = joptim.sgd(jsched, MOMENTUM, WD)
        opt, sched = optim.sgd([{"params": list(tm.parameters())}], tsched,
                               LR, MOMENTUM, WD)
        if mode == "base":
            jstep = jloop.make_base_step(jm, tx)
            tstep = loop.make_base_step(tm, opt, sched)
        else:
            jcfg = jloop.AlfaConfig(tap=5, steps=2)
            jstep = jloop.make_alfa_step(jm, tx, jcfg)
            tstep = loop.make_alfa_step(
                tm, opt, sched, loop.AlfaConfig(tap=5, steps=2))
        gamma = 1.5 / 255
    state = jloop.TrainState.create(vs, tx)
    for i in range(2):
        x, y = batch(i + 1)
        if mode == "base":
            state, jm_out = jstep(state, jnp.asarray(x), jnp.asarray(y))
        else:
            state, jm_out = jstep(state, jnp.asarray(x), jnp.asarray(y),
                                  jax.random.PRNGKey(i))
        out = tstep(torch.from_numpy(x), torch.from_numpy(y))
        for k in ("loss", "accuracy"):
            close(float(out[k]), float(jm_out[k]), msg=f"step {i} {k}")
        if mode != "base":
            check_ascents(rec, gamma, out["pert_l2"].numpy(),
                          out["pert_linf"].numpy(),
                          np.asarray(jm_out["pert_l2"]),
                          np.asarray(jm_out["pert_linf"]))
        if mode == "learnable":
            close(out["w"].numpy(), jm_out["w"], msg=f"step {i} w")
            assert abs(float(out["w"].sum()) - 1.0) < 1e-6
    compare_states(tm, opt, state)
    return tm


def test_base_step(variables):
    tm = run_both(variables, "base")
    # w gets no gradient in the base step, but weight decay moves it
    assert not torch.equal(tm.w.detach(), torch.full((9,), 1.0 / 9))


def test_alfa_step(variables, recorded):
    run_both(variables, "alfa", recorded)


def test_learnable_step(variables, recorded):
    run_both(variables, "learnable", recorded)


def test_eval_step_and_metrics(variables):
    jm, vs = variables
    x, y = batch(5)
    tm = ResNetS(BLOCKS, NC)
    tm.load_state_dict(resnet_s_variables_to_state_dict(vs))
    want = jloop.make_eval_step(jm)(jloop.TrainState.create(
        vs, joptim.sgd(lambda c: 0.0)), jnp.asarray(x), jnp.asarray(y))
    got = loop.make_eval_step(tm)(torch.from_numpy(x), torch.from_numpy(y))
    for k in ("loss", "accuracy", "correct", "count"):
        close(float(got[k]), float(want[k]), msg=k)
    w = torch.tensor([0.3, 0.5, 0.1])
    close(loop.sum_project(w).numpy(), jloop.sum_project(jnp.asarray(w)))


def test_multistep_warmup_schedule_matches_optax():
    # tests/test_train.py:45-52, plus the edges of each piece
    j = joptim.multistep_warmup_schedule(0.1, [100, 200], 0.1,
                                         warmup_steps=10)
    t = optim.multistep_warmup_schedule(0.1, [100, 200], 0.1,
                                        warmup_steps=10)
    for count in (0, 1, 5, 9, 10, 50, 99, 100, 150, 199, 200, 250):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6,
                                   atol=1e-9, err_msg=str(count))
    assert t(0) == 0.0 and t(9) == pytest.approx(0.1)


def test_learnable_sgd_groups():
    m = ResNetS(BLOCKS, NC)
    opt, sched = optim.learnable_sgd(m, lambda c: 0.1 * (c + 1), 0.1, 0.01)
    model_g, w_g = opt.param_groups
    assert w_g["params"] == [m.w] and w_g["weight_decay"] == 0.0
    assert len(model_g["params"]) == len(list(m.parameters())) - 1
    assert model_g["weight_decay"] == 5e-4
    sched.step()
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.2, 0.01])


def test_synthetic_arrays_and_loaders_are_byte_identical():
    for seed in (0, 5):
        for a, b in zip(jcifar.synthetic_arrays(300, 50, 10, seed),
                        cifar.synthetic_arrays(300, 50, 10, seed)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    tx, ty, _, _ = cifar.synthetic_arrays(100, 10, 10, 1)
    for rotate in (False, True):
        ja = jcifar.augment_batch(tx[:16], np.random.RandomState(2), rotate)
        ta = cifar.augment_batch(tx[:16], np.random.RandomState(2), rotate)
        assert np.array_equal(ja, ta)
    for raw in (False, True):
        jl = jcifar.CifarLoader(tx, ty, 16, True, seed=3, raw=raw)
        tl = cifar.CifarLoader(tx, ty, 16, True, seed=3, raw=raw)
        assert len(jl) == len(tl) == 6
        for (jx, jy), (tx_, ty_) in zip(list(jl) + list(jl),
                                        list(tl) + list(tl)):
            assert np.array_equal(jx, tx_) and np.array_equal(jy, ty_)
    jv = jcifar.CifarLoader(tx, ty, 32, False)
    tv = cifar.CifarLoader(tx, ty, 32, False)
    assert len(jv) == len(tv) == 4
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(jv, tv))


def test_cifar_readers(tmp_path):
    rng = np.random.RandomState(4)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (6, 3072)),
                         "labels": list(rng.randint(0, 10, 6))}, f)
    binroot = tmp_path / "bin" / "cifar-10-batches-bin"
    binroot.mkdir(parents=True)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rng.randint(0, 256, (4, 3073)).astype(np.uint8).tofile(binroot / name)
    for root in (str(tmp_path), str(tmp_path / "bin")):
        want, got = jcifar.load_cifar(root, 10), cifar.load_cifar(root, 10)
        assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert cifar.load_cifar(str(tmp_path / "none"), 10) is None


def test_augment_batch_device_crops_and_flips():
    x = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (64, 32, 32, 3)).astype(np.uint8))
    gen = torch.Generator().manual_seed(0)
    out = cifar.augment_batch_device(x, gen)
    again = cifar.augment_batch_device(x, torch.Generator().manual_seed(0))
    assert out.dtype == torch.float32 and out.shape == (64, 32, 32, 3)
    assert torch.equal(out, again)
    padded = torch.nn.functional.pad(x.float() / 255.0, (0, 0, 4, 4, 4, 4))
    flipped = 0
    for i in range(len(x)):
        crops = [(padded[i, r:r + 32, c:c + 32], f)
                 for r in range(9) for c in range(9) for f in (False, True)]
        hits = [f for crop, f in crops
                if torch.equal(out[i], crop.flip(1) if f else crop)]
        assert hits, i
        flipped += hits[0]
    assert 10 < flipped < 54        # flips with probability 1/2


def test_checkpoint_round_trip_into_afan(variables, tmp_path):
    jm, vs = variables
    tm = ResNetS(BLOCKS, NC, 1.0 / 9)
    tm.load_state_dict(resnet_s_variables_to_state_dict(vs))
    opt, sched = optim.sgd([{"params": list(tm.parameters())}],
                           lambda c: 0.1, 0.1)
    path = save_classify_checkpoint(str(tmp_path / "checkpoint.pt"), tm, opt,
                                    sched, epoch=3, step=7, best_prec1=12.5)
    saved = load_training_state(path)
    assert (saved["epoch"], saved["step"], saved["best_prec1"]) == (3, 7,
                                                                   12.5)
    params, stats, frac = load_torch_resnet_s(path, BLOCKS)
    assert frac == 1.0
    x, _ = batch(9)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), 0, None, False)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.numpy(), want, rel=1e-5)


def small_loaders(train_batch_size, test_batch_size, data_dir, seed):
    """A 48 / 16 / 16 split of the synthetic CIFAR, so that the CLI's
    validation passes take seconds on the CPU."""
    tx, ty, ex, ey = cifar.synthetic_arrays(64, 16, 10, seed)
    return (cifar.CifarLoader(tx[:48], ty[:48], train_batch_size, True, seed),
            cifar.CifarLoader(tx[48:], ty[48:], test_batch_size, False),
            cifar.CifarLoader(ex, ey, test_batch_size, False))


def test_cli_on_cpu_with_resume_and_inference(tmp_path, monkeypatch):
    monkeypatch.setattr(train_classify, "cifar10_dataloaders", small_loaders)
    monkeypatch.setattr(infer_classify, "cifar10_dataloaders", small_loaders)
    common = ["--device", "cpu", "--epochs", "1", "--limit_batches", "2",
              "--batch_size", "8", "--print_freq", "1", "--data",
              "/nonexistent"]
    for mode in ("base", "alfa", "learnable"):
        d = str(tmp_path / mode)
        best = train_classify.main(common + ["--mode", mode, "--save_dir", d])
        assert np.isfinite(best)
        for f in ("checkpoint.pt", "best_model.pt", "result.pkl",
                  "result_norm.pkl"):
            assert os.path.isfile(os.path.join(d, f)), (mode, f)
        with open(os.path.join(d, "result.pkl"), "rb") as f:
            result = pickle.load(f)
        assert [len(v) for v in result.values()] == [1, 1, 1]
    d = str(tmp_path / "alfa")
    saved = load_training_state(os.path.join(d, "checkpoint.pt"))
    assert saved["epoch"] == 1 and saved["step"] == 2
    train_classify.main(common[:3] + ["2"] + common[4:] + [
        "--mode", "alfa", "--save_dir", d, "--resume"])
    resumed = load_training_state(os.path.join(d, "checkpoint.pt"))
    assert resumed["epoch"] == 2 and resumed["step"] == 4
    assert resumed["scheduler"]["last_epoch"] == 4
    with open(os.path.join(d, "result_norm.pkl"), "rb") as f:
        norms = pickle.load(f)
    assert list(norms["l2"]) == [2] and norms["l2"][2] > 0
    acc = infer_classify.main(["--device", "cpu", "--batch_size", "8",
                               "--pretrained",
                               os.path.join(d, "best_model.pt")])
    assert 0.0 <= acc <= 100.0


def test_cli_resume_restores_everything(tmp_path, monkeypatch):
    monkeypatch.setattr(train_classify, "cifar10_dataloaders", small_loaders)
    d = str(tmp_path)
    argv = ["--device", "cpu", "--mode", "base", "--epochs", "1",
            "--limit_batches", "1", "--batch_size", "8", "--save_dir", d,
            "--host_aug"]
    train_classify.main(argv)
    saved = load_training_state(os.path.join(d, "checkpoint.pt"))
    logs = []
    monkeypatch.setattr(train_classify.Log, "i", logs.append)
    train_classify.main(argv + ["--resume"])       # epochs done: no training
    assert any("restored 100.0% of the model" in m and
               "optimizer state restored" in m for m in logs)
    again = load_training_state(os.path.join(d, "checkpoint.pt"))
    assert all(torch.equal(v, again["state_dict"][k])
               for k, v in saved["state_dict"].items())


@pytest.mark.parametrize("flag", [["--bf16"], ["--epoch_scan"],
                                  ["--num_devices", "2"]])
def test_cli_refuses_unported_flags(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_classify.main(["--device", "cpu", "--save_dir", str(tmp_path)]
                            + flag)


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_classify.main(["--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_classify.main(["--pretrained", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        infer_classify.main(["--pretrained", str(tmp_path), "--pgd"])
