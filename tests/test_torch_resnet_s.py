"""afan_torch's ResNet-s (``models/{taps,resnet_s}.py``) against afan's on
the same numpy input and weights: ``ResNetS(num_blocks=(1, 1, 1),
num_classes=4)``, 16x16 inputs, batch 8, as ``tests/test_train.py``. The
weights reach the port through ``resnet_s_variables_to_state_dict``.

The port runs NCHW and ``afan`` NHWC, so 4-D features are transposed before
they are compared. Tolerance: each feature within 1e-5 of its largest
magnitude (float32 convolutions and BatchNorm statistics summed in another
order), in train mode (batch statistics) and eval mode (running ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.interop.torch_ckpt import resnet_s_params_to_torch_sd
from afan.models import resnet_s as jresnet_s
from afan_torch.interop.from_jax import resnet_s_variables_to_state_dict
from afan_torch.models import resnet_s
from afan_torch.models.taps import check_tap
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
BLOCKS = (1, 1, 1)


def close(got, want, rel=REL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    if want.ndim == 4:
        want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0, err_msg=msg,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def setup():
    jm = jresnet_s.ResNetS(num_blocks=BLOCKS, num_classes=4,
                           init_weight=1.0 / 9)
    rng = np.random.RandomState(0)
    x = rng.rand(8, 16, 16, 3).astype(np.float32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x), 0, None, False))
    # non-trivial running statistics, so eval mode tests them
    variables["batch_stats"] = jax.tree.map(
        lambda v: (v + rng.rand(*v.shape).astype(np.float32)),
        variables["batch_stats"])
    return jm, variables, x


def port(variables):
    tm = resnet_s.ResNetS(BLOCKS, 4, 1.0 / 9)
    tm.load_state_dict(resnet_s_variables_to_state_dict(variables),
                       strict=True)
    return tm


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("train", [False, True])
def test_every_tap_and_the_logits(setup, train):
    jm, variables, x = setup
    tm = port(variables)
    tm.train(train)
    for tap in range(jm.num_stages + 1):
        want = jm.apply(variables, jnp.asarray(x), 0, tap, train,
                        mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = tm(nchw(x), 0, tap) if train else tm.head(nchw(x), tap)
        close(got.numpy(), want, msg=f"tap {tap}")
        # the tail from afan's own feature gives afan's logits
        if tap < jm.num_stages:
            feat = np.asarray(want)
            feat_t = torch.from_numpy(feat.transpose(0, 3, 1, 2).copy()
                                      if feat.ndim == 4 else feat.copy())
            with torch.no_grad():
                logits = tm.tail(feat_t, tap)
            close(logits.numpy(),
                  jm.apply(variables, jnp.asarray(x), 0, None, train,
                           mutable=["batch_stats"])[0], msg=f"tail {tap}")


def test_multi_head_equals_per_tap_head(setup):
    jm, variables, x = setup
    tm = port(variables)
    taps = (7, 2, 4, 4, 10)
    tm.train(True)
    with torch.no_grad():
        multi = tm.multi_head(nchw(x), taps)
        single = [tm.head(nchw(x), t) for t in taps]
    want = jm.apply(variables, jnp.asarray(x), taps, True,
                    method=jm.multi_head, mutable=["batch_stats"])[0]
    for t, m, s, w in zip(taps, multi, single, want):
        assert torch.equal(m, s), t
        close(m.numpy(), w, msg=f"tap {t}")
    with pytest.raises(ValueError):
        tm.multi_head(nchw(x), ())
    with pytest.raises(ValueError):
        check_tap(tm.num_stages + 1, tm.num_stages)


def test_running_stats_after_one_train_forward(setup):
    jm, variables, x = setup
    tm = port(variables)
    tm.train()
    with torch.no_grad():
        tm(nchw(x))
    _, updates = jm.apply(variables, jnp.asarray(x), 0, None, True,
                          mutable=["batch_stats"])
    want = resnet_s_variables_to_state_dict(
        {"batch_stats": jax.device_get(updates["batch_stats"])})
    got = tm.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            close(got[k].numpy(), v.numpy(), msg=k)


def test_keys_are_the_reference_layout(setup):
    _, variables, _ = setup
    tm = port(variables)
    want = resnet_s_params_to_torch_sd(variables["params"],
                                       variables["batch_stats"], BLOCKS)
    got = {k for k in tm.state_dict()
           if not k.endswith("num_batches_tracked")}
    assert got == set(want)
    for k, v in tm.state_dict().items():
        if k in want:
            assert np.array_equal(v.numpy(), want[k]), k
    r56 = resnet_s.resnet56()
    assert r56.num_stages == 34
    assert "sequential_model.33.weight" in r56.state_dict()


def test_init_is_seeded_kaiming_fan_in():
    a = resnet_s.resnet56(generator=torch.Generator().manual_seed(3))
    b = resnet_s.resnet56(generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(v, b.state_dict()[k])
               for k, v in a.state_dict().items())
    fc = a.sequential_model[33]
    assert not fc.bias.any() and torch.equal(a.w, torch.ones(9))
    conv = a.sequential_model[13].conv1.weight       # 16 → 32, fan_in 144
    assert abs(float(conv.std()) - (2.0 / 144) ** 0.5) < 0.01
    bn = a.sequential_model[2]
    assert torch.equal(bn.weight, torch.ones(16)) and not bn.bias.any()
    assert bn.momentum == pytest.approx(0.1)


@pytest.mark.parametrize("name,stages", [("resnet20", 16), ("resnet32", 22),
                                         ("resnet44", 28), ("resnet56", 34),
                                         ("resnet110", 61)])
def test_factories(name, stages):
    m = getattr(resnet_s, name)()
    assert m.num_stages == stages == getattr(jresnet_s, name)().num_stages
    assert resnet_s.LEARNABLE_TAPS == jresnet_s.LEARNABLE_TAPS
