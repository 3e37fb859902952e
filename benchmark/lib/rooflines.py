"""Least times of the hand-written kernels' work in a traced training
window, from the calls the reference counted for one step (their shapes)
and the traced steps' batches (their valid pixels)."""
from __future__ import annotations

from typing import Optional

from . import bounds, harness


def least_seconds(layer, op: str, half: Optional[str] = None) -> float:
    """The sum over the traced steps and the step's calls of ``op`` of each
    call's least time (``half``: 'fwd' or 'bwd' of the upsample + CE)."""
    total = 0.0
    for batch in layer.traced_batches:
        for call in layer.calls:
            if call.op != op:
                continue
            if op == "resize_ce":
                b, c, h, w = call.shape
                H = W = layer.config["crop_size"]
                parts = bounds.resize_ce_parts(
                    b, c, h, w, H, W, call.reps * layer.valid[batch],
                    call.elem_bytes)[half]
            else:
                n = 1
                for d in call.shape:
                    n *= d
                parts = bounds.pgd_parts(n, call.elem_bytes, False)
            total += bounds.least_seconds(*parts)[0]
    return total


def share(layer, op: str, kernel_op: str, half: Optional[str] = None
          ) -> Optional[float]:
    """The roofline share (%) of the kernels that ``benchmark/kernels/``
    names for ``kernel_op``; None where the trace holds none of them or the
    step makes no such call."""
    seconds = layer.trace.seconds_of(harness.kernel_names(kernel_op))
    least = least_seconds(layer, op, half)
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
