"""afan_torch's CLI surface and tools against afan's: the segmentation
parser's ten flags of ``afan``'s TPU runs and reference scripts,
``--fused_ce off`` against ``on``, the once-refused flags, the trainers' scalar
logs, ``plot_results``, ``StepTimer``, ``time_chained_windows``,
``measure_rtt`` and ``profile_trace`` on the CPU.

The CLI runs here use the cheapest model (``recipes/_common.sh``'s
SMOKE_TINY sizes) and write no TensorBoard file: ``ScalarWriter`` is
patched to ``use_tensorboard=False``, since ``torch.utils.tensorboard``
imports TensorFlow (about 15 s) where it is installed. Scalars are
compared on tag, value and step (``ts`` is the wall time).
"""
import functools
import json
import os
import pickle
import shlex
import sys
import types

import numpy as np
import pytest
import torch

from afan.cli import plot_results as j_plot_results
from afan.cli import train_segment as j_train_segment
from afan.utils import observe as j_observe
from afan.utils import timing as j_timing
from afan_torch.cli import plot_results, train_detect, train_segment
from afan_torch.ops.kernels import resize_ce as krce
from afan_torch.train import segment_loop
from afan_torch.utils import observe, timing
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEN_FLAGS = {"remat_tails": ["--remat_tails"],
             "backbone_remat": ["--backbone_remat"],
             "fused_ce": ["--fused_ce", "off"],
             "num_devices": ["--num_devices", "1"],
             "spatial_shards": ["--spatial_shards", "1"],
             "download": ["--download"], "gpu_id": ["--gpu_id", "0"],
             "vis_port": ["--vis_port", "8097"],
             "vis_env": ["--vis_env", "main"],
             "adv_type": ["--adv_type", "pgd"]}
SEG_TINY = ["--device", "cpu", "--dataset", "synthetic", "--crop_size", "32",
            "--batch_size", "2", "--val_batch_size", "4", "--print_interval",
            "1", "--model", "deeplabv3plus_mobilenet", "--mix_sd"]
DET_TINY = ["--device", "cpu", "--variant", "baseline", "--data_dir",
            "/nonexistent", "--backbone", "resnet18", "--batch_size", "2",
            "--image_min_side", "64", "--image_max_side", "96",
            "--anchor_sizes", "[16,32]", "--rpn_pre_nms_top_n", "256",
            "--rpn_post_nms_top_n", "64", "--num_steps_to_finish", "2",
            "--num_steps_to_snapshot", "2"]


@pytest.fixture
def no_tensorboard(monkeypatch):
    for mod in (train_segment, train_detect):
        monkeypatch.setattr(mod, "ScalarWriter", functools.partial(
            observe.ScalarWriter, use_tensorboard=False))


def records(path):
    with open(path) as f:
        return [{k: r[k] for k in ("tag", "value", "step")}
                for r in map(json.loads, f)]


@pytest.mark.parametrize("flag", sorted(TEN_FLAGS))
def test_seg_parser_takes_afans_flag(flag):
    """Each flag parses to ``afan``'s value, and its default and choices
    are ``afan``'s."""
    port, ref = train_segment.get_parser(), j_train_segment.get_parser()
    assert (getattr(port.parse_args([]), flag)
            == getattr(ref.parse_args([]), flag))
    assert (getattr(port.parse_args(TEN_FLAGS[flag]), flag)
            == getattr(ref.parse_args(TEN_FLAGS[flag]), flag))
    choices = {a.dest: a.choices for a in ref._actions}
    assert {a.dest: a.choices for a in port._actions}[flag] == choices[flag]


def test_reference_command_line_with_gpu_and_visdom_flags_parses():
    """``recipes/seg_city_final.sh``'s command line plus the reference
    scripts' ``--gpu_id 0 --vis_port 8097``."""
    with open(os.path.join(ROOT, "recipes", "seg_city_final.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "-m afan.cli.train_segment" in ln)
    line = (line.replace("${N}", "1").replace("${GAMMASE}", "0.02")
            .replace("${MIX}", "01")
            .replace("$(seg_smoke_flags)", "--data_root ./data"))
    argv = shlex.split(line)
    argv = argv[argv.index("afan.cli.train_segment") + 1:] + [
        "--gpu_id", "0", "--vis_port", "8097"]
    args = train_segment.get_parser().parse_args(argv)
    ref = j_train_segment.get_parser().parse_args(argv)
    for k, v in vars(ref).items():
        if k in vars(args):
            assert getattr(args, k) == v, k
    assert args.gpu_id == "0" and args.fused_ce == "auto"


@pytest.mark.parametrize("flag", [["--num_devices", "2"],
                                  ["--spatial_shards", "2", "--num_devices",
                                   "2"],
                                  ["--remat_tails"], ["--backbone_remat"]])
def test_seg_cli_refuses_unported_flags(flag, tmp_path, monkeypatch):
    """The flags that were not ported once, and are now, train: ``--num_devices
    2`` (data parallelism) on two gloo processes, where rank 0 writes the
    checkpoints, and so does ``--spatial_shards 2`` on those two (a 1 x 2
    data x spatial mesh), logging ``afan``'s mesh line; ``--remat_tails``
    builds the A-FAN step with the spectrum tails recomputed and
    ``--backbone_remat`` (on a ResNet-18 DeepLab: MobileNetV2 ignores it)
    a backbone that recomputes its four stages
    (``tests/test_torch_remat.py`` holds both to the plain step)."""
    monkeypatch.chdir(tmp_path)
    argv = SEG_TINY + ["--limit_itrs", "1", "--val_interval", "1"] + flag
    model = "deeplabv3plus_mobilenet"
    built = []
    if "--num_devices" not in flag:
        model = "deeplabv3plus_resnet50"
        argv += ["--model", model]
        real_build, real_step = (train_segment.build_model,
                                 train_segment.make_afan_seg_step)
        monkeypatch.setattr(train_segment, "build_model", lambda *a, **kw: (
            built.append(kw["backbone_remat"]) or real_build(*a, **kw)))
        monkeypatch.setattr(train_segment, "make_afan_seg_step",
                            lambda *a, **kw: (built.append(a[3].remat_tails)
                                              or real_step(*a, **kw)))
    train_segment.main(argv)
    (exp,) = os.listdir("checkpoints")
    assert sorted(f for f in os.listdir(os.path.join("checkpoints", exp))
                  if f.endswith(".pt")) == [
        f"best_{model}_synthetic.pt", f"latest_{model}_synthetic.pt"]
    log = open(os.path.join("checkpoints", exp, "train.log")).read()
    assert ("2-D mesh: data=1 x spatial=2" in log) == (
        "--spatial_shards" in flag)
    if built:
        assert built == [flag == ["--backbone_remat"],
                         flag == ["--remat_tails"]]


def test_seg_cli_fused_ce_off_equals_on_and_logs_afans_scalars(
        tmp_path, monkeypatch, no_tensorboard):
    """Two A-FAN iterations and a validation each way from the same seed:
    on the CPU ``on`` runs the kernels' plain version, ``off`` the
    library's upsample and cross-entropy (``fused_resize_nll_sums`` is not
    called); the losses agree within 1e-6 relative and no kernel
    launches. ``--download`` logs that nothing is downloaded, and
    ``--num_devices 1 --spatial_shards 1`` run. The scalars go to
    ``runs/<exp>/scalars.jsonl`` at ``afan``'s steps."""
    logs, fused_calls = [], []
    monkeypatch.setattr(train_segment.Log, "i", logs.append)
    real = segment_loop.fused_resize_nll_sums
    monkeypatch.setattr(segment_loop, "fused_resize_nll_sums",
                        lambda *a: fused_calls.append(mode) or real(*a))
    before = (krce.fwd_launches, krce.bwd_launches)
    runs = {}
    for mode in ("on", "off"):
        d = tmp_path / mode
        d.mkdir()
        monkeypatch.chdir(d)
        one_device = (["--num_devices", "1", "--spatial_shards", "1"]
                      if mode == "off" else [])
        train_segment.main(SEG_TINY + ["--limit_itrs", "2", "--val_interval",
                                       "2", "--fused_ce", mode, "--download",
                                       "--gpu_id", "0", "--vis_port", "8097"]
                           + one_device)
        (exp,) = os.listdir("runs")
        runs[mode] = records(os.path.join("runs", exp, "scalars.jsonl"))
    assert (krce.fwd_launches, krce.bwd_launches) == before
    assert fused_calls and set(fused_calls) == {"on"}
    assert any("--download requested" in m for m in logs)
    on, off = runs["on"], runs["off"]
    assert [(r["tag"], r["step"]) for r in on] == [
        ("train/loss", 1), ("train/loss", 2), ("val/mIoU", 2)]
    assert [(r["tag"], r["step"]) for r in off] == [
        (r["tag"], r["step"]) for r in on]
    for a, b in zip(on, off):
        assert abs(a["value"] - b["value"]) <= 1e-6 * max(abs(a["value"]),
                                                           1e-6), (a, b)
    assert np.isfinite([r["value"] for r in on]).all()


def test_detect_cli_logs_train_loss_under_summaries(tmp_path,
                                                    no_tensorboard):
    out = str(tmp_path)
    train_detect.main(DET_TINY + ["-o", out])
    got = records(os.path.join(out, "summaries", "scalars.jsonl"))
    assert [(r["tag"], r["step"]) for r in got] == [("train/loss", 1),
                                                   ("train/loss", 2)]
    assert np.isfinite([r["value"] for r in got]).all()


def test_scalar_writer_records_equal_afans(tmp_path):
    losses = [(f"train/loss", 2.5 - 0.1 * i, i + 1) for i in range(5)] + [
        ("val/mIoU", 0.125, 5), ("train/loss", np.float32(1.75), 6)]
    for mod, d in ((observe, "port"), (j_observe, "afan")):
        w = mod.ScalarWriter(str(tmp_path / d), use_tensorboard=False)
        for tag, value, step in losses:
            w.add_scalar(tag, value, step)
        w.close()
    assert records(tmp_path / "port" / "scalars.jsonl") == records(
        tmp_path / "afan" / "scalars.jsonl")
    assert len(records(tmp_path / "port" / "scalars.jsonl")) == 7


def result_dir(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    with open(d / "result.pkl", "wb") as f:
        pickle.dump({"train": [40.0, 55.5, 61.25], "ta": [38.5, 57.0, 52.75],
                     "test_ta": [37.0, 56.25, 51.0]}, f)
    with open(d / "result_norm.pkl", "wb") as f:
        pickle.dump({"l2": {1: 0.5, 2: 0.75, 3: 0.625},
                     "linf": {1: 0.01, 2: 0.02, 3: 0.015}}, f)
    return d


def test_plot_results_prints_afans_best_epoch_and_writes_a_png(tmp_path,
                                                               capsys):
    d = result_dir(tmp_path)
    j_plot_results.main([str(d), "--out", str(tmp_path / "afan.png")])
    want = capsys.readouterr().out.splitlines()
    plot_results.main([str(d), "--out", str(tmp_path / "port.png")])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "best epoch 2: val 57.00, test 56.25"
    assert got[1] == f"wrote {tmp_path / 'port.png'}"
    with open(tmp_path / "port.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_results_names_matplotlib_where_it_is_missing(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    d = result_dir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_results.main([str(d)])
    assert capsys.readouterr().out.startswith("best epoch 2:")


class FakeClock:
    """A clock that moves by the given steps, one per read."""

    def __init__(self, steps):
        self.t, self.steps = 1000.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.0
        return self.t


def test_step_timer_keeps_afans_cadence_and_message(monkeypatch):
    reads = [0.0] + [1.5, 0.0, 3.25, 0.0, 0.5, 0.0] * 2
    messages = {}
    for name, mod in (("port", observe), ("afan", j_observe)):
        clock = FakeClock(reads)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=clock))
        timer = mod.StepTimer(batch_size=8, total_steps=100,
                              display_every=4)
        messages[name] = [timer.tick(s) for s in range(1, 25)]
    assert messages["port"] == messages["afan"]
    assert [m is not None for m in messages["port"]] == [
        s % 4 == 0 for s in range(1, 25)]
    assert messages["port"][3] == "21.33 samples/sec; ETA 0.0 hrs"


def test_time_chained_windows_as_afans(monkeypatch):
    """The same (min, median) per iteration from the same clock, with the
    round trip subtracted; ``fetch`` ends each window."""
    got = {}
    for name, mod in (("port", timing), ("afan", j_timing)):
        calls = []
        clock = FakeClock([0.0, 0.6, 0.0, 0.9, 0.0, 0.3])
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=clock))
        got[name] = mod.time_chained_windows(
            lambda: calls.append("run"), lambda: calls.append("fetch"),
            iters=3, windows=3, rtt=0.03)
        assert calls == (["run"] * 3 + ["fetch"]) * 3
    assert got["port"] == got["afan"]
    assert got["port"] == pytest.approx((0.09, 0.19))


def test_measure_rtt_on_the_cpu():
    rtt = timing.measure_rtt(probes=3, device="cpu")
    assert 0.0 < rtt < 1.0


def test_profile_trace_writes_a_trace_of_the_block(tmp_path):
    x = torch.randn(64, 64)
    with observe.profile_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert any("aten::mm" in e.key for e in prof.key_averages())
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        trace = json.load(f)
    assert any(ev.get("name") == "aten::mm" for ev in trace["traceEvents"])
