"""Result plotting and best-epoch picker — the PyTorch port's counterpart of
``afan/cli/plot_results.py`` (the reference's `Classification/plot.py` and
`Classification/show.py`), on what ``afan_torch.cli.train_classify`` writes
into its ``--save_dir``: ``result.pkl`` (per epoch ``train``, ``ta`` and
``test_ta`` accuracies) and ``result_norm.pkl`` (the perturbations' mean
``l2`` and ``linf`` norms by epoch)::

    python -m afan_torch.cli.plot_results SAVE_DIR [--out curves.png]

It prints the best validation epoch first, then draws the accuracy curves
(and the norms where there are any) into ``--out`` (default
``SAVE_DIR/curves.png``) with matplotlib, which it imports only then and
names where it is missing.
"""
from __future__ import annotations

import argparse
import os
import pickle


def best_epoch_line(result: dict):
    """``afan``'s line for the epoch of the best validation accuracy
    (1-based), or None without epochs."""
    ta = result.get("ta", [])
    test_ta = result.get("test_ta", [])
    if not ta:
        return None
    best = max(range(len(ta)), key=lambda i: ta[i])
    return (f"best epoch {best + 1}: val {ta[best]:.2f}"
            + (f", test {test_ta[best]:.2f}" if best < len(test_ta) else ""))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="best epoch and curves of a classification run")
    p.add_argument("save_dir", help="trainer save_dir with result*.pkl")
    p.add_argument("--out", default=None, help="plot output path (png)")
    args = p.parse_args(argv)

    with open(os.path.join(args.save_dir, "result.pkl"), "rb") as f:
        result = pickle.load(f)
    line = best_epoch_line(result)
    if line is not None:
        print(line)

    norm_path = os.path.join(args.save_dir, "result_norm.pkl")
    norms = None
    if os.path.exists(norm_path):
        with open(norm_path, "rb") as f:
            norms = pickle.load(f)

    out = args.out or os.path.join(args.save_dir, "curves.png")
    try:
        import matplotlib
    except ImportError:
        raise ImportError("plot_results draws with matplotlib, which is not "
                          "installed; the best epoch is printed above") \
            from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    with_norms = bool(norms and norms.get("l2"))
    fig, axes = plt.subplots(1, 2 if with_norms else 1, figsize=(10, 4))
    ax0 = axes[0] if with_norms else axes
    ax0.plot(result.get("train", []), label="train_acc")
    ax0.plot(result.get("ta", []), label="TA")
    ax0.plot(result.get("test_ta", []), label="test_TA")
    ax0.set_xlabel("epoch")
    ax0.legend()
    if with_norms:
        epochs = sorted(norms["l2"])
        axes[1].plot(epochs, [norms["l2"][e] for e in epochs], label="L2")
        axes[1].plot(epochs, [norms["linf"][e] for e in epochs],
                     label="Linf")
        axes[1].set_xlabel("epoch")
        axes[1].set_title("perturbation norms")
        axes[1].legend()
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
