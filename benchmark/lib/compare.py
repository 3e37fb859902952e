"""The readings that decide a training cell's ``correct``: a side (the
program, the reference, the control) drives its step through the first
steps on the same batches from the same seeded weights, and these numbers
compare it with the reference.

- ``loss_gap``: the largest over the steps of ``|l - l_ref| / |l_ref|``.
- ``grad_gap``: the first gradient as the optimizer gets it (SGD's
  momentum buffer after one step less the weight decay's share), by the
  worst leaf: ``|‖g‖ - ‖g_ref‖| / max(‖g_ref‖, median leaf's ‖g_ref‖)``.
- ``change_gap``: the parameters' change over the steps, by the worst leaf
  in the same measure; leaves whose reference gradient is under a
  thousandth of the median leaf's (nought to rounding, so moved by the
  momentum of round-off) are left out.

A cell whose traffic file says ``"compare": "first_step"`` reads the
loss and the change of the first step instead, and prints the later ones:
there both sides are deterministic, but the differences of the first step
(the upsample + CE kernel sums in another order than the plain reference)
grow through the later steps' sign ascents and the recipe's lr into gaps
as wide as the control's (``PERF.md``). The first step's change is then
the first gradient times the lr where the step is sound; it is still
compared, since a step that puts its parameters back leaves the gradient
in the optimizer's state and only the change reads it. A cell's limits
name the numbers it compares.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence

import torch

NEGLIGIBLE_GRAD = 1e-3


@dataclasses.dataclass
class Readings:
    """One side's first steps, reduced to numbers on the host."""
    losses: List[float]
    grad_norms: Dict[str, float]
    first_change_norms: Dict[str, float]
    change_norms: Dict[str, float]


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch._foreach_norm([tensors[n].float() for n in names])
    return dict(zip(names, torch.stack(norms).cpu().tolist()))


def first_steps(step: Callable[[int], torch.Tensor],
                params: Dict[str, torch.Tensor],
                optimizer: torch.optim.Optimizer,
                initial: Dict[str, torch.Tensor], weight_decay: float,
                steps: int) -> Readings:
    """Run ``step(k)`` for k < ``steps`` (each returns the loss) and read
    the first gradient from ``optimizer``'s momentum buffers after the
    first (zero where a step left none), and the change of ``params`` from
    ``initial`` after the first and after the last."""
    losses, grads, first = [], None, None
    for k in range(steps):
        losses.append(step(k))
        if k == 0:
            grads = {}
            for name, p in params.items():
                buf = optimizer.state.get(p, {}).get("momentum_buffer")
                if buf is None:
                    buf = torch.zeros_like(p)
                grads[name] = buf - weight_decay * initial[name]
            grads = _norms(grads)
            first = _norms({n: p.detach() - initial[n]
                            for n, p in params.items()})
    change = _norms({n: p.detach() - initial[n] for n, p in params.items()})
    return Readings([float(l) for l in losses], grads, first, change)


def _median(values: Sequence[float]) -> float:
    return float(torch.tensor(list(values), dtype=torch.float64).median())


def worst_leaf(side: Dict[str, float], ref: Dict[str, float],
               leaves: Sequence[str]) -> float:
    floor = _median(ref[n] for n in leaves)
    return _largest(abs(side[n] - ref[n]) / max(ref[n], floor, 1e-30)
                    for n in leaves)


def _largest(values) -> float:
    """The largest value, and infinity where any is not finite."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def leaf_gaps(side: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    floor = _median(ref[n] for n in leaves)
    return {n: abs(side[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in leaves}


def diagnostics(side: Readings, ref: Readings) -> Dict:
    """What the look at a side's gaps reads: each step's loss gap, the
    worst leaves and the median leaf's gap of the gradient and the
    change."""
    out = {"loss_gaps": [abs(a - b) / max(abs(b), 1e-30)
                         for a, b in zip(side.losses, ref.losses)],
           "last_change_gap": worst_leaf(side.change_norms,
                                         ref.change_norms, _moving(ref))}
    names, moving = list(ref.grad_norms), _moving(ref)
    for key, s, r, leaves in (
            ("grad", side.grad_norms, ref.grad_norms, names),
            ("change", side.change_norms, ref.change_norms, moving)):
        g = leaf_gaps(s, r, leaves)
        worst = sorted(g, key=g.get, reverse=True)[:3]
        out[f"{key}_worst"] = [[n, g[n], r[n]] for n in worst]
        out[f"{key}_median_gap"] = _median(g.values())
    return out


def _moving(ref: Readings) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    median_grad = _median(ref.grad_norms.values())
    return [n for n, g in ref.grad_norms.items()
            if g >= NEGLIGIBLE_GRAD * median_grad]


def gaps(side: Readings, ref: Readings,
         compare: str = "all_steps") -> Dict[str, float]:
    """The three compared numbers of ``side`` against ``ref``, over all the
    steps or (``"first_step"``) the first."""
    steps = 1 if compare == "first_step" else len(ref.losses)
    loss = _largest(abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(side.losses[:steps], ref.losses[:steps]))
    s, r = ((side.first_change_norms, ref.first_change_norms)
            if compare == "first_step" else
            (side.change_norms, ref.change_norms))
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(side.grad_norms, ref.grad_norms,
                                   list(ref.grad_norms)),
            "change_gap": worst_leaf(s, r, _moving(ref))}
