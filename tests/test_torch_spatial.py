"""afan_torch's spatial sharding (``--spatial_shards``) on the CPU, gloo
ranks through ``afan_torch.parallel.launch`` (rank side in
``tests/torch_spatial_ranks.py`` and, for the A-FAN steps,
``tests/torch_dp_ranks.py:run``; neither imports jax):

- ``window_rows`` and its backward at S=2 and S=3, with an empty shard, an
  empty window and halos longer than a neighbour's share: every window
  equals the slice of the whole map padded with the fill, and every input
  gradient the gradient of those slices (integer values: exact);
- each row-sharded op against its unsharded self, forward and input
  gradient, and its parameter gradients summed over the ranks, at S=2 and
  S=3: ``Conv2d`` for k in {1, 3, 7}, stride in {1, 2} and dilation in {1,
  2, 6, 18}, the stem's max pool, the decoder's ``resize_bilinear`` in
  float32 and bfloat16, ``GlobalMean`` through a train-mode
  ``ASPPPooling``, and the site's windowed plain upsample + CE; maps of 2
  rows leave a rank without rows;
- the noise of a row-sharded step: the S ranks of a data row draw the data
  row's noise and keep their rows, and draw the same step sizes;
- the A-FAN seg step of ``afan``'s dryrun (``__graft_entry__.py:276-294``:
  DeepLabv3+ MobileNetV2, 4 classes, OS 16, batch 2, 64x64) and of a
  DeepLabv3+ ResNet-18 at OS 8 (the ASPP's rates 12-36 on shards of 4
  rows), at 1x2 and 2x2, from numpy-seeded weights carried by
  ``from_jax`` (``tests/test_torch_mobilenet.py:seeded_variables``):
  in float32 against ``afan``'s 1-device step at ``AFAN_REL``
  (``tests/test_torch_dp.py``'s tolerance), and in float64 against the
  port's own Dx1 step at ``WORLD_REL``, the Dx1 step replaying the DxS
  ascents and its own differing from them in at most ``FLIP_FRACTION`` of
  the entries; the ResNet-18's step at 1x2 with ``--backbone_remat
  --remat_tails`` against the same step without them, bit for bit. The
  Dx1 comparison is made in float64 because at a batch of
  2 the float32 step amplifies rounding by orders of magnitude (its
  ascent gradients move by 0.5-1.6% when the convolutions only change
  shape, and MobileNetV2's parameters by 4e-5 of their norm, as far as the
  port's world-1 step lies from ``afan``'s); in float64 the sharded step's
  ascent gradients are within 2e-7 of the Dx1 step's (the upsample + CE
  computes in float32 in both) and no entry flips;
- the CLI at ``afan``'s test arguments (``tests/test_sharding.py:133-147``,
  on 2x2 ranks: ``--num_devices 4``), at 1x4 with crop 32 (at OS 16 the 2
  rows fall on 2 of the 4 ranks), and its three refusals with ``afan``'s
  messages.

The launches and ``afan``'s compiles run at once, in threads of one module
fixture (:func:`runs`); the tests read their results.
"""
import concurrent.futures
import os
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.models.deeplab import modeling as jmodeling
from afan.parallel import mesh as jmesh
from afan.train import segment_loop as jseg_loop
from afan_torch.cli import train_segment
from afan_torch.interop.from_jax import deeplab_variables_to_state_dict
from afan_torch.parallel import mesh as dp
from afan_torch.parallel.launch import launch
from afan_torch.parallel.mesh import split_rows

import test_torch_segment as tseg
import torch_dp_ranks
import torch_spatial_ranks
from test_torch_dp import (AFAN_REL, FLIP_FRACTION, SEG, WORLD_REL,
                           against_world_one)
from test_torch_mobilenet import seeded_variables
from torch_threads import one_torch_thread  # noqa: F401

OP_REL = 1e-5       # a row-sharded float32 op against its unsharded self
BF16_GRAD_REL = 2e-2  # bfloat16 input gradients: partial sums rounded apart
SIZES = (2, 3)


def close(got, want, rel, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max() if want.size else 0, 1e-6), (
        msg, err)


# ---------- window_rows ----------

def window_case(name, size, h, windows, fill):
    rng = np.random.RandomState(len(name))
    x = rng.randint(-9, 10, (2, 3, h, 4)).astype(np.float32)
    probes = [rng.randint(-9, 10, (2, 3, hi - lo, 4)).astype(np.float32)
              for lo, hi in windows]
    return dict(name=name, size=size, x=x, windows=windows, fill=fill,
                probes=probes)


WINDOW_CASES = [
    # rank 1 reads past the bottom and 2 of rank 0's 3 rows
    window_case("s2-edges", 2, 5, [(-2, 4), (1, 9)], 0.0),
    window_case("s2-pool-fill", 2, 5, [(-1, 3), (2, 6)], float("-inf")),
    # 2 rows over 3 ranks: rank 2 owns none, and its window is 12 rows
    window_case("s3-empty-shard", 3, 2, [(-1, 2), (0, 3), (-5, 7)], 0.0),
    # rank 0's window is empty; rank 1's halo is longer than the shares
    window_case("s3-long-halo", 3, 7, [(0, 0), (-3, 9), (2, 5)], 0.0),
]


def window_expected(case):
    """Each rank's window of the padded whole map and the input gradient
    of those slices, in the map's rows."""
    x, h = case["x"], case["x"].shape[2]
    pad = max([0] + [max(-lo, hi - h) for lo, hi in case["windows"]])
    padded = np.full(x.shape[:2] + (h + 2 * pad,) + x.shape[3:],
                     case["fill"], np.float32)
    padded[:, :, pad:pad + h] = x
    grad = np.zeros((x.shape[0], x.shape[1], h + 2 * pad, x.shape[3]),
                    np.float32)
    wins = []
    for (lo, hi), probe in zip(case["windows"], case["probes"]):
        wins.append(padded[:, :, lo + pad:hi + pad])
        grad[:, :, lo + pad:hi + pad] += probe
    return wins, grad[:, :, pad:pad + h]


# ---------- the ops ----------

def op_cases():
    rng = np.random.RandomState(0)
    cases = []

    def add(name, kind, x, params=None, state=None, labels=None):
        cases.append(dict(name=name, kind=kind, x=x.astype(np.float32),
                          params=params or {}, state=state or {},
                          labels=labels))

    x20 = rng.randn(2, 3, 20, 6)
    for k in (1, 3, 7):
        for stride in (1, 2):
            for dil in (1, 2, 6, 18):
                bias = dil == 1
                state = {"weight": (rng.randn(4, 3, k, k) / k).astype(
                    np.float32)}
                if bias:
                    state["bias"] = rng.randn(4).astype(np.float32)
                add(f"conv-k{k}-s{stride}-d{dil}", "conv", x20,
                    dict(cin=3, cout=4, k=k, stride=stride, dilation=dil,
                         bias=bias), state)
    add("pool", "pool", x20)
    add("pool-2rows", "pool", rng.randn(2, 3, 2, 6))
    for dt in ("float32", "bfloat16"):
        add(f"resize-{dt}", "resize", rng.randn(2, 3, 5, 6),
            dict(W=24, H=20, dtype=dt))
    add("resize-2rows", "resize", rng.randn(2, 3, 2, 4),
        dict(W=16, H=8, dtype="float32"))
    pooling = {"1.weight": rng.randn(4, 3, 1, 1).astype(np.float32),
               "2.weight": (1 + 0.1 * rng.randn(4)).astype(np.float32),
               "2.bias": (0.1 * rng.randn(4)).astype(np.float32),
               "2.running_mean": np.zeros(4, np.float32),
               "2.running_var": np.ones(4, np.float32),
               "2.num_batches_tracked": np.zeros((), np.int64)}
    # four entries whose means lie far apart: the BatchNorm over the pooled
    # values (one per entry and channel) takes a variance of order one,
    # which the global BatchNorm's E[x^2] - E[x]^2 keeps to float32's
    # digits, and its input gradient is no near-cancellation (with two
    # entries the normalized values are +-1 whatever the input)
    offset = np.array([1.0, -1.0, 0.5, -0.2])[:, None, None, None]
    add("aspp-pooling", "pooling", rng.randn(4, 3, 7, 5) * 0.3 + offset,
        dict(cin=3, cout=4), pooling)
    add("aspp-pooling-2rows", "pooling", rng.randn(4, 3, 2, 5) * 0.3
        + offset, dict(cin=3, cout=4), pooling)
    for name, (h, w), (H, W) in (("ce", (5, 6), (20, 24)),
                                 ("ce-2rows", (2, 4), (8, 16))):
        labels = rng.randint(0, 4, (2, H, W)).astype(np.int64)
        labels[0, :3, :5] = 255
        labels[1, -2:, :] = 255
        add(name, "ce", rng.randn(2, 4, h, w), labels=labels)
    return cases


def with_probes(cases):
    """Each case with a probe of its output's shape (the output's
    gradient)."""
    rng = np.random.RandomState(1)
    out = []
    for c in cases:
        if c["kind"] != "ce":
            x = torch.from_numpy(c["x"])
            m = torch_spatial_ranks.module_of(c)
            with torch.no_grad():
                if m is not None:
                    m.train()
                shape = torch_spatial_ranks.apply(
                    c, m, x, c["params"].get("H", 0)).shape
            c = dict(c, probe=rng.randn(*shape).astype(np.float32))
        out.append(c)
    return out


# ---------- the runs, at once ----------

MODELS = {"mobilenet-os16": ("mobilenet", 16),
          "resnet18-os8": ("resnet18", 8)}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
NC, B, HW = 4, 2, 64
# afan's test arguments (tests/test_sharding.py:133-147)
CLI = ["--variant", "afan", "--dataset", "voc", "--data_root",
       "/nonexistent", "--model", "deeplabv3plus_mobilenet", "--crop_size",
       "32", "--batch_size", "4", "--limit_itrs", "2", "--val_interval", "2",
       "--exp", "sptest", "--device", "cpu"]
CLI_MESHES = {"2x2": (["--spatial_shards", "2", "--num_devices", "4"],
                      "data=2 x spatial=2"),
              "1x4-uneven": (["--spatial_shards", "4", "--num_devices", "4"],
                             "data=1 x spatial=4")}


def step_payloads():
    """{model: (payload, variables)}: the dryrun's batch (brightness per
    entry, as ``tests/test_torch_deeplab.py:batch``; 25 ignored pixels in
    the top rows of entry 0, so the ranks' valid-pixel counts differ) and
    seeded weights."""
    rng = np.random.RandomState(0)
    scale = np.array([0.5, 1.0], np.float32)[:, None, None, None]
    images = (rng.rand(B, HW, HW, 3) * scale).astype(np.float32)
    labels = rng.randint(0, NC, (B, HW, HW)).astype(np.int32)
    labels[0, :5, :5] = 255
    out = {}
    for name, (backbone, os_) in MODELS.items():
        jm = jmodeling.DeepLab(backbone_name=backbone, num_classes=NC,
                               output_stride=os_)
        variables = seeded_variables(jm, rng, jnp.asarray(images[:1]),
                                     False)
        out[name] = (dict(deeplab=(backbone, NC, os_), cfg=SEG, lr=tseg.LR,
                          total=tseg.TOTAL, batches=[{"inputs": [images,
                                                                 labels]}],
                          state_dict=deeplab_variables_to_state_dict(
                              variables)), variables)
    return out


def afan_step(payload, variables):
    """afan's 1-device A-FAN step (SD concat, AFN on the spectrum's
    adversarial point, ``mix_sd``; dropout off): its metrics and state."""
    backbone, nc, os_ = payload["deeplab"]
    jm = jmodeling.DeepLab(backbone_name=backbone, num_classes=nc,
                           output_stride=os_)
    state, tx = tseg.jax_state(variables)
    step = jseg_loop.make_afan_seg_step(
        jm, tx, jseg_loop.SegAfanConfig(fused_ce=False, **SEG))
    images, labels = payload["batches"][0]["inputs"]
    state, m = step(state, jnp.asarray(images), jnp.asarray(labels),
                    jax.random.PRNGKey(7))
    return {k: np.asarray(v) for k, v in m.items()}, state


def blocks(ranks, data, size, i):
    """Ascent ``i``'s global perturbation from the ranks' blocks (data rows
    on axis 0, image rows on axis 2)."""
    return np.concatenate([np.concatenate(
        [ranks[d * size + s]["ascents"][i][0] for s in range(size)], axis=2)
        for d in range(data)])


_in_process = threading.Lock()


def port_steps(payload):
    """{mesh: (the float32 DxS ranks, the float64 DxS ranks, their global
    ascents, the float64 Dx1 ranks replaying them, the float32 Dx1 ranks
    on their own ascents)}; for the ResNet-18 at 1x2 also {(mesh, "remat"):
    (the float32 ranks, the float32 ranks of the step with
    ``backbone_remat`` and ``remat_tails``)} from the same launch.
    ``torch_dp_ranks.run`` in this process patches module globals: one at a
    time."""
    out = {}
    for name, (data, size) in MESHES.items():
        payloads = [dict(payload, mesh=(data, size)),
                    dict(payload, mesh=(data, size), float64=True)]
        recompute = (name, payload["deeplab"][0]) == ("1x2", "resnet18")
        if recompute:
            payloads.append(dict(payload, mesh=(data, size),
                                 backbone_remat=True,
                                 cfg=dict(payload["cfg"], remat_tails=True)))
        f32, f64, *remat = zip(*launch(
            torch_dp_ranks.runs, data * size, ("seg", payloads),
            device="cpu", timeout=600))
        if recompute:
            out[name, "remat"] = (f32, remat[0])
        replay = [blocks(f64, data, size, i)
                  for i in range(len(f64[0]["ascents"]))]
        args = ("seg", [dict(payload, float64=True, replay=replay),
                        payload])
        if data > 1:
            dx1 = launch(torch_dp_ranks.runs, data, args, device="cpu",
                         timeout=600)
        else:
            with _in_process:
                dx1 = [torch_dp_ranks.runs(0, *args)]
        dx1_64, dx1_32 = zip(*dx1)
        out[name] = (f32, f64, replay, dx1_64, dx1_32)
    return out


def cli_run(extra, where):
    launch(torch_spatial_ranks.cli_rank, 4, (CLI + extra, str(where)),
           device="cpu", timeout=600)
    return where


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the file and ``afan``'s steps, started at once:
    {name: future}."""
    ops = with_probes(op_cases())
    payloads = step_payloads()
    whole = {c["name"]: torch_spatial_ranks.one_process(c) for c in ops}
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, *a, **k: inputs)
        futures = {"cases": (ops, whole), "payloads": payloads}
        for size in SIZES:
            windows = [c for c in WINDOW_CASES if c["size"] == size]
            futures[size] = pool.submit(
                launch, torch_spatial_ranks.op_rank, size,
                (size, windows, ops), device="cpu", timeout=300)
        for name, (extra, _) in CLI_MESHES.items():
            futures[name] = pool.submit(cli_run, extra,
                                        tmp_path_factory.mktemp(name))
        for name, (payload, variables) in payloads.items():
            futures["afan", name] = pool.submit(afan_step, payload,
                                                variables)
            futures["port", name] = pool.submit(port_steps, payload)
        yield futures


@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: c["name"])
def test_window_rows_and_its_backward(case, runs):
    ranks = runs[case["size"]].result()
    wins, grad = window_expected(case)
    for r, out in enumerate(ranks):
        win, gx = out[case["name"]]
        np.testing.assert_array_equal(win, wins[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(
            gx, grad[:, :, split_rows(grad.shape[2], r, case["size"])],
            err_msg=f"rank {r} gradient")


OP_NAMES = [c["name"] for c in op_cases()]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", OP_NAMES)
def test_row_sharded_op_matches_its_unsharded_self(name, size, runs):
    ops, whole = runs["cases"]
    case = next(c for c in ops if c["name"] == name)
    ranks = [r[name] for r in runs[size].result()]
    y, gx, gp = whole[name]
    if case["kind"] == "ce":
        close(sum(r[0] for r in ranks), y, 1e-6, "the shares' sum")
        close(np.concatenate([r[1] for r in ranks], axis=2), gx, OP_REL,
              "logits gradient")
        return
    got_y = np.concatenate([r[0] for r in ranks], axis=2)
    got_gx = np.concatenate([r[1] for r in ranks], axis=2)
    if case["params"].get("dtype") == "bfloat16":
        np.testing.assert_array_equal(got_y, y)
        close(got_gx, gx, BF16_GRAD_REL, "input gradient")
        return
    close(got_y, y, OP_REL, "output")
    close(got_gx, gx, OP_REL, "input gradient")
    for k, g in gp.items():
        close(sum(r[2][k] for r in ranks), g, OP_REL, f"gradient of {k}")


# ---------- the noise ----------

def test_data_row_draws_its_noise_and_keeps_its_rows():
    """On a 2 x 2 mesh the generator's seed follows the data coordinate:
    the two ranks of a data row draw one map and keep their rows (2 and 3
    of 5), and the same step sizes; the data rows draw apart."""
    out = launch(torch_spatial_ranks.draws_rank, 4, (2, 2, 5, (1, 2, 5, 3)),
                 device="cpu", timeout=300)
    assert [o["coords"] for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in (0, 1):
        a, b = out[2 * d], out[2 * d + 1]
        seed = 5 if d == 0 else None
        gen = torch.Generator()
        if seed is not None:
            gen.manual_seed(seed)
            whole = torch.rand((1, 2, 5, 3), generator=gen).numpy()
            np.testing.assert_array_equal(
                np.concatenate([a["noise"], b["noise"]], axis=2), whole)
        assert a["noise"].shape[2] == 3 and b["noise"].shape[2] == 2
        np.testing.assert_array_equal(a["steps"], b["steps"])
    assert not np.array_equal(out[0]["steps"], out[2]["steps"])


def test_shard_batch_spatial_takes_the_block_or_refuses_afans_rows():
    """A rank's block of a global batch on a 2 x 4 mesh (its data row's
    batch rows, then its image rows), and ``afan``'s refusal of 30 rows
    over 4 shards, with its message."""
    mesh = dp.Mesh2D(2, 4, 1, 2, (4, 5, 6, 7))
    a = np.arange(2 * 32 * 3).reshape(2, 32, 3)
    np.testing.assert_array_equal(dp.shard_batch_spatial(mesh, a),
                                  a[1:2, 16:24])
    with pytest.raises(ValueError) as want:
        jmesh.shard_batch_spatial(jmesh.make_mesh_2d(2, 4),
                                  np.zeros((2, 30, 8, 3), np.float32))
    with pytest.raises(ValueError) as e:
        dp.shard_batch_spatial(mesh, np.zeros((2, 30, 8, 3), np.float32))
    assert str(e.value) == str(want.value)


# ---------- the A-FAN step ----------

def flat(state, keys, minus=None):
    return np.concatenate([np.ravel(state[k]) - (0 if minus is None else
                                                 np.ravel(minus[k]))
                           for k in keys])


def against_afan(got, own, variables, state):
    """All parameters and statistics together within ``AFAN_REL`` of their
    norm (per tensor a batch of 2 leaves near-cancellations: MobileNetV2's
    projection biases reach the loss only through a later BatchNorm, and
    the image pooling's BatchNorm normalizes two values); the trained
    parameters' update within twice the distance of the port's own
    float32 Dx1 update (``own``) from afan's, and no less than 2e-3
    (``tests/test_torch_segment.py``'s update tolerance): float32 moves
    these steps' updates by some 3e-3 to 7e-3 of their norm, in either
    framework."""
    before = {k: v.numpy() for k, v in
              deeplab_variables_to_state_dict(variables).items()}
    want = {k: v.numpy() for k, v in deeplab_variables_to_state_dict(
        jax.device_get({"params": state.params,
                        "batch_stats": state.batch_stats})).items()}
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    tseg.close_l2(flat(got, keys), flat(want, keys), AFAN_REL,
                  "all parameters and statistics")
    trained = [k for k in keys if not k.endswith(("running_mean",
                                                  "running_var"))]
    upd = flat(want, trained, before)

    def err(st):
        return np.linalg.norm(flat(st, trained, before) - upd) / \
            np.linalg.norm(upd)
    assert err(got) <= max(2 * err(own), 2e-3), (err(got), err(own))


def same_on_every_rank(ranks):
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(v, r["state"][k], err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", list(MODELS))
def test_spatial_step_matches_afan_and_the_data_parallel_step(model, mesh,
                                                              runs):
    f32, f64, replay, dx1, own = runs["port", model].result()[mesh]
    want, state = runs["afan", model].result()
    variables = runs["payloads"][model][1]
    same_on_every_rank(f32)
    same_on_every_rank(f64)
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        close(f32[0]["metrics"][0][k], want[k], AFAN_REL, k)
    same_on_every_rank(own)
    against_afan(f32[0]["state"], own[0]["state"], variables, state)
    # float64: the Dx1 step's own ascents against the DxS ones it replays
    for i, (own, gamma) in enumerate(dx1[0]["ascents"]):
        mine = np.concatenate([r["ascents"][i][0] for r in dx1])
        flips = np.abs(mine - replay[i]) > gamma / 2
        assert flips.mean() <= FLIP_FRACTION, (i, flips.mean())
    against_world_one(f64[0], dx1[0])


def test_spatial_step_recomputes_bit_for_bit(runs):
    """``--backbone_remat --remat_tails`` on the 1x2 mesh: every rank's
    recompute runs the halo exchanges and the global BatchNorm's
    all-reduces again, in the same order, and the step is the one without
    recomputation bit for bit, running statistics included."""
    plain, recomputed = runs["port", "resnet18-os8"].result()["1x2", "remat"]
    for p, r in zip(plain, recomputed):
        assert r["metrics"] == p["metrics"]
        for k, v in p["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
        for k, v in p["momenta"].items():
            np.testing.assert_array_equal(r["momenta"][k], v, err_msg=k)


# ---------- the CLI ----------

@pytest.mark.parametrize("name", list(CLI_MESHES))
def test_cli_trains_on_the_mesh(name, runs):
    """2 steps and a validation; rank 0 writes the checkpoints and the log.
    At 1x4 the OS-16 maps of crop 32 have 2 rows, which fall on 2 of the 4
    ranks. Each rank runs ``train_segment.main`` as its launcher runs it
    (``tests/test_torch_cli_tools.py`` runs the whole CLI at 1x2, the
    launch included), writing no TensorBoard file."""
    where = runs[name].result()
    (exp,) = os.listdir(where / "checkpoints")
    files = sorted(os.listdir(where / "checkpoints" / exp))
    assert files == ["best_deeplabv3plus_mobilenet_voc.pt",
                     "latest_deeplabv3plus_mobilenet_voc.pt", "train.log"]
    text = (where / "checkpoints" / exp / "train.log").read_text()
    assert f"2-D mesh: {CLI_MESHES[name][1]}" in text
    assert "[Val] itrs 2" in text and "done; best mIoU" in text


@pytest.mark.parametrize("extra,error,message", [
    (["--spatial_shards", "2", "--num_devices", "3"], SystemExit,
     "device count 3 must divide by --spatial_shards 2"),
    (["--spatial_shards", "2", "--num_devices", "4", "--batch_size", "1"],
     ValueError, None),
    (["--spatial_shards", "2", "--num_devices", "2", "--crop_size", "33"],
     SystemExit, "--crop_size must divide by --spatial_shards"),
], ids=["devices", "batch", "crop"])
def test_cli_refuses_what_afan_refuses(extra, error, message, tmp_path,
                                       monkeypatch):
    """``afan``'s checks and messages (`afan/cli/train_segment.py:274-289`;
    the batch's from ``afan``'s ``check_divisible`` of ``batch * S`` on the
    mesh), raised before any rank starts or anything is written."""
    monkeypatch.chdir(tmp_path)
    if message is None:
        with pytest.raises(ValueError) as want:
            jmesh.check_divisible(1 * 2, jmesh.make_mesh_2d(2, 2))
        message = str(want.value)
    with pytest.raises(error) as e:
        train_segment.main(CLI + extra)
    assert str(e.value) == message
    assert not os.path.exists("checkpoints")
