"""afan_torch's data-parallel building blocks (``afan_torch/parallel``) on
the CPU, two gloo ranks per launch (rank side in
``tests/torch_dp_ranks.py``):

- the mesh helpers: ``check_divisible`` with ``afan``'s message, each
  rank's contiguous rows, the broadcast of rank 0's parameters and
  optimizer state, the gradient sum in flat buckets (fewer all-reduces
  than tensors), the 1 x 1 spatial mesh of one process, the launcher's
  failures (a rank that raises, a rank that hangs) and a run that outlives
  its collective timeout (a launch has no wall-clock limit unless given
  one);
- the global BatchNorm at world 2, forward and backward: against the
  port's one-process BatchNorm on the global batch (within 1e-5 of each
  tensor's largest entry), and against flax's ``nn.BatchNorm`` on the
  global batch (within 1e-5 likewise), running statistics included, with
  the statistics updated and frozen;
- the segmentation loss's global valid-pixel count with unequal
  ignore-255 counts per rank: the ranks' shares sum to the one-process loss
  and their logits' gradients are its rows (within 1e-6), where averaging
  the ranks' own means would be off by far more;
- the loaders under ``shard``: each rank's rows of the one-process
  batches, the segmentation train pipeline's draws for the other ranks'
  rows made from the label's size without decoding it (on disk, VOC and
  Cityscapes trees).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan_torch.models.resnet import BatchNorm, frozen_bn_stats
from afan_torch.parallel import mesh as dp
from afan_torch.parallel.launch import launch
from afan_torch.train import segment_loop

import torch_dp_ranks
from afan.parallel import mesh as jmesh
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5


def close(got, want, rel=REL, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), (msg, err)


def test_mesh_helpers_outside_a_group():
    assert (dp.world_size(), dp.rank(), dp.is_main(), dp.data_group()) == (
        1, 0, True, None)
    assert dp.resolve_size(None, "cpu") == 1
    assert dp.resolve_size(4, "cpu") == 4
    with pytest.raises(ValueError, match="at least 1"):
        dp.resolve_size(0, "cpu")
    for n in (3, 5):
        with pytest.raises(ValueError) as e:
            dp.check_divisible(n, 2)
        with pytest.raises(ValueError) as want:
            jmesh.check_divisible(n, jmesh.make_mesh(2))
        assert str(e.value) == str(want.value)
    assert [dp.split_rows(5, r, 2) for r in (0, 1)] == [slice(0, 3),
                                                       slice(3, 5)]
    assert dp.split_rows(8, 1, 2) == slice(4, 8)
    assert dp.rank_rows(8) == slice(0, 8)
    np.testing.assert_array_equal(dp.shard_batch(np.arange(6)), np.arange(6))
    assert dp.rank_seed(7) == 7
    x = torch.ones(3)
    assert dp.share(x) is x and dp.global_sum(x) is x
    # one process holds a 1 x 1 mesh and no other (afan's message)
    with pytest.raises(ValueError, match="need 2 devices for a 1x2 mesh, "
                                         "have 1"):
        dp.make_mesh_2d(1, 2)
    mesh = dp.make_mesh_2d(1, 1)
    assert (mesh.shape, mesh.size, mesh.spatial_group) == (
        {"data": 1, "spatial": 1}, 1, None)
    np.testing.assert_array_equal(
        dp.shard_batch_spatial(mesh, np.arange(12).reshape(2, 3, 2)),
        np.arange(12).reshape(2, 3, 2))
    assert dp.rank_rows(8) == slice(0, 8) and dp.rank_seed(7) == 7


def test_mesh_helpers_in_a_group():
    sizes = [5, 3, 20, 1, 7]
    out = launch(torch_dp_ranks.helpers_rank, 2, (6, sizes), device="cpu",
                 timeout=300)
    assert [o["rows"] for o in out] == [[0, 1, 2], [3, 4, 5]]
    assert out[0]["seed"] == 5 and out[1]["seed"] != 5
    for o in out:
        # rank 0's parameters (1 - 0.1 after its step) and momentum,
        # broadcast
        np.testing.assert_array_equal(o["weight"], np.full((2, 3), 0.9,
                                                           np.float32))
        np.testing.assert_array_equal(o["momentum"], np.full((2, 3), 10.0))
        for i, g in enumerate(o["grads"]):
            np.testing.assert_array_equal(g, np.full(sizes[i], 3.0 * (i + 1)))
        # 64-byte buckets: (5 + 3), (20), (1 + 7) floats
        assert o["calls"] == [8, 20, 8]


def test_launch_reports_a_failing_and_a_hanging_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised") as e:
        launch(torch_dp_ranks.raising_rank, 2, device="cpu", timeout=60)
    assert "rank one fails on purpose" in str(e.value)
    with pytest.raises(RuntimeError, match="did not finish within 8 s"):
        launch(torch_dp_ranks.hanging_rank, 2, device="cpu", deadline=8)


def test_launch_outlives_its_collective_timeout():
    """A run longer than the collective timeout finishes: the launch (and
    the trainers' ``--num_devices``, through ``launch_cli``) puts no
    wall-clock limit on the ranks."""
    assert launch(torch_dp_ranks.slow_rank, 2, (6.0,), device="cpu",
                  timeout=3) == [0, 1]


def bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 3) * rng.rand(1, 6, 1, 1) * 3
         + rng.randn(1, 6, 1, 1)).astype(np.float32)
    return x, (1 + 0.2 * rng.randn(6)).astype(np.float32), \
        (0.1 * rng.randn(6)).astype(np.float32)


def one_process_bn(x, weight, bias, update):
    bn = BatchNorm(6, momentum=0.01)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    probe = torch.linspace(-1, 1, x.size, dtype=torch.float64).reshape(
        x.shape).float()
    if update:
        y = bn(xt)
    else:
        with frozen_bn_stats(bn):
            y = bn(xt)
    (y * probe).sum().backward()
    return {"y": y.detach().numpy(), "gx": xt.grad.numpy(),
            "gw": bn.weight.grad.numpy(), "gb": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def flax_bn(x, weight, bias):
    """flax's BatchNorm (afan's, momentum 0.99) in train mode on the global
    batch, NHWC: output, gradients of sum(y * probe), new statistics."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5)
    xn = jnp.asarray(x.transpose(0, 2, 3, 1))
    probe = jnp.asarray(np.linspace(-1, 1, x.size).reshape(x.shape)
                        .astype(np.float32).transpose(0, 2, 3, 1))
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}

    def f(xn, scale, b):
        y, upd = bn.apply({"params": {"scale": scale, "bias": b},
                           "batch_stats": stats}, xn, mutable=["batch_stats"])
        return (y * probe).sum(), (y, upd["batch_stats"])

    (_, (y, new)), (gx, gw, gb) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(xn, jnp.asarray(weight),
                                            jnp.asarray(bias))
    return {"y": np.asarray(y).transpose(0, 3, 1, 2),
            "gx": np.asarray(gx).transpose(0, 3, 1, 2), "gw": gw, "gb": gb,
            "mean": new["mean"], "var": new["var"]}


@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
def test_global_batchnorm_matches_one_process_and_flax(update):
    x, weight, bias = bn_inputs()
    ranks = launch(torch_dp_ranks.bn_rank, 2, (x, weight, bias, 0.01,
                                               update), device="cpu",
                   timeout=300)
    got = {k: np.concatenate([r[k] for r in ranks]) for k in ("y", "gx")}
    for k in ("gw", "gb", "mean", "var"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        got[k] = ranks[0][k]
    one = one_process_bn(x, weight, bias, update)
    want = flax_bn(x, weight, bias)
    for k in ("y", "gx", "gw", "gb", "mean", "var"):
        close(got[k], one[k], msg=f"{k} against one process")
        if update or k not in ("mean", "var"):
            close(got[k], want[k], msg=f"{k} against flax")
    if not update:
        np.testing.assert_array_equal(got["mean"], np.zeros(6))
        np.testing.assert_array_equal(got["var"], np.ones(6))


def test_global_pixel_count_with_unequal_ignores_per_rank():
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 5, 6, 6).astype(np.float32)
    logits[:2] *= 4                # rank 0's pixels lose more per pixel
    labels = rng.randint(0, 5, (4, 24, 24)).astype(np.int32)
    labels[:2, :20] = 255          # rank 0 keeps 4 of every 24 rows
    ranks = launch(torch_dp_ranks.npix_rank, 2, (logits, labels),
                   device="cpu", timeout=300)
    assert [r["valid"] for r in ranks] == [2 * 4 * 24, 2 * 24 * 24]
    lo = torch.from_numpy(logits).requires_grad_(True)
    site = segment_loop._site_loss(torch.from_numpy(labels), None,
                                   fused=True)
    loss = site(lo)[0]
    loss.backward()
    for r in ranks:
        close(r["global"], float(loss.detach()), rel=1e-6, msg="global loss")
    close(ranks[0]["share"] + ranks[1]["share"], float(loss.detach()),
          rel=1e-6)
    close(np.concatenate([r["grad"] for r in ranks]), lo.grad.numpy(),
          rel=1e-6, msg="logit gradients")
    # the mean of the ranks' own means is another number
    npix = sum(r["valid"] for r in ranks)
    local_means = [r["share"] * npix / r["valid"] for r in ranks]
    loss = float(loss.detach())
    assert abs(np.mean(local_means) - loss) > 1e-2 * loss


def test_loaders_give_each_rank_its_rows_of_the_one_process_batches():
    """Under ``shard = (rank, 2)`` the detection loader decodes only the
    rank's rows and the segmentation loader's evaluation batches hold only
    the rank's rows (an odd batch split unevenly), each equal to those rows
    of the one-process batches, the random flips and crops included."""
    from afan_torch.data.seg_data import voc_seg_loaders
    from afan_torch.data.voc_det import voc_detection_loaders

    def det(rank=None):
        loader = voc_detection_loaders(None, 4, 64, 96, seed=3)[0]
        if rank is not None:
            loader.shard = (rank, 2)
        return [next(it) for it in [iter(loader)] for _ in range(3)]

    for whole, b0, b1 in zip(det(), det(0), det(1)):
        for field in ("images", "boxes", "labels", "valid", "scales"):
            np.testing.assert_array_equal(
                np.concatenate([getattr(b0, field), getattr(b1, field)]),
                getattr(whole, field))
        assert b0.image_ids + b1.image_ids == whole.image_ids

    def seg(rank=None):
        train, val, _ = voc_seg_loaders(None, 4, 32, seed=3,
                                        val_batch_size=3)
        if rank is not None:
            train.shard = val.shard = (rank, 2)
        return ([next(it) for it in [iter(train)] for _ in range(2)],
                list(val))

    (t_all, v_all), (t0, v0), (t1, v1) = seg(), seg(0), seg(1)
    for whole, p0, p1 in list(zip(t_all, t0, t1)) + list(zip(v_all, v0,
                                                            v1)):
        for i in (0, 1):
            np.testing.assert_array_equal(
                np.concatenate([p0[i], p1[i]]) if len(p1[i]) else p0[i],
                whole[i])
    assert [len(b[0]) for b in v0][:2] == [2, 2]
    assert [len(b[0]) for b in v1][:2] == [1, 1]


@pytest.mark.parametrize("dataset", ["voc", "cityscapes"])
def test_train_transform_skip_draws_what_the_transform_draws(dataset):
    """``skip`` on an item's size leaves the stream where the transform
    leaves it and returns the size of the transform's output, for items
    smaller and larger than the crop."""
    from afan_torch.data.ext_transforms import (cityscapes_train_transform,
                                                voc_train_transform)
    make = (voc_train_transform if dataset == "voc"
            else cityscapes_train_transform)
    t = make(24)
    for i, (h, w) in enumerate([(40, 50), (17, 30), (24, 24), (90, 13)]):
        img = np.random.RandomState(i).rand(h, w, 3).astype(np.float32)
        lab = np.zeros((h, w), np.int32)
        applied, skipped = (np.random.RandomState(100 + i) for _ in range(2))
        out = t(img, lab, applied)
        assert t.skip((h, w), skipped) == out[1].shape
        assert applied.randint(1 << 30) == skipped.randint(1 << 30)


def test_seg_train_loader_decodes_only_its_rows_on_disk(tmp_path,
                                                        monkeypatch):
    """On VOC and Cityscapes trees of several image sizes, each rank's
    train batches are its rows of the one-process batches over two epochs,
    and a rank decodes its rows and no others."""
    from afan_torch.data import seg_data
    from chip_smoke import write_png

    rng = np.random.RandomState(4)
    voc = tmp_path / "VOC2012"
    ids = [f"v{i}" for i in range(6)]
    for i, (h, w) in zip(ids, [(40, 50), (17, 30), (36, 36), (90, 13),
                               (28, 44), (50, 20)]):
        write_png(str(voc / "JPEGImages" / f"{i}.jpg"),
                  rng.randint(0, 256, (h, w, 3)))
        write_png(str(voc / "SegmentationClass" / f"{i}.png"),
                  rng.randint(0, 21, (h, w)), palette=np.zeros((256, 3)))
    (voc / "ImageSets" / "Segmentation").mkdir(parents=True)
    for split in ("train", "val"):
        (voc / "ImageSets" / "Segmentation" / f"{split}.txt").write_text(
            "\n".join(ids) + "\n")
    city = tmp_path / "city"
    for i in range(6):
        stem = f"aachen_{i:06d}_000019"
        for kind, arr in (("leftImg8bit", rng.randint(0, 256, (20, 40, 3))),
                          ("gtFine", rng.randint(0, 34, (20, 40)))):
            name = (f"{stem}_leftImg8bit.png" if kind == "leftImg8bit"
                    else f"{stem}_gtFine_labelIds.png")
            write_png(str(city / kind / "train" / "aachen" / name), arr)
            (city / kind / "val" / "aachen").mkdir(parents=True,
                                                   exist_ok=True)
    loaders = {"voc": lambda: seg_data.voc_seg_loaders(str(voc), 4, 24,
                                                       seed=3)[0],
               "cityscapes": lambda: seg_data.cityscapes_loaders(
                   str(city), 4, 24, seed=3)[0]}
    decoded = []
    real = seg_data._load_pair

    def counting(s, *a):
        decoded.append(s.image_path)
        return real(s, *a)
    monkeypatch.setattr(seg_data, "_load_pair", counting)
    for name, make in loaders.items():
        def epochs(rank=None):
            loader = make()
            if rank is not None:
                loader.shard = (rank, 2)
            decoded.clear()
            out = [b for _ in range(2) for b in loader]
            return out, len(decoded)

        (whole, n_all), (b0, n0), (b1, n1) = epochs(), epochs(0), epochs(1)
        assert len(whole) == 2 and (n_all, n0, n1) == (8, 4, 4), name
        for w, p0, p1 in zip(whole, b0, b1):
            for i in (0, 1):
                np.testing.assert_array_equal(
                    np.concatenate([p0[i], p1[i]]), w[i], err_msg=name)
