"""Recomputation — the port's counterpart of ``afan``'s ``jax.checkpoint``
(``--remat_tails``) and ``nn.remat`` (``--backbone_remat``): a region's
forward keeps only its inputs, and the backward runs the region again to
get the activations its gradient needs.

:func:`remat` is built on ``torch.utils.checkpoint.checkpoint`` with
``use_reentrant=False`` (the ascents differentiate with
``torch.autograd.grad``, which the reentrant variant does not support). A
``jax.checkpoint`` recomputes a pure function; a PyTorch region is not
one, and ``checkpoint`` alone would change the step in two ways that no
loss value shows:

- **BatchNorm running statistics.** A train-mode :class:`BatchNorm`
  updates its running statistics in place on every forward, so a
  recomputed region would apply the EMA twice. The recompute runs under
  :func:`replayed_bn_stats`, the recompute's form of
  :func:`afan_torch.models.resnet.frozen_bn_stats`: each BatchNorm of the
  region takes the code path its first forward took (with the running
  statistics' update, or frozen), so the normalization is the first
  forward's bit for bit, and the recompute's EMA lands in copies that are
  dropped. Under data parallelism the global statistics' all-reduce runs
  again, on every rank alike.
- **Explicit generators.** ``preserve_rng_state`` stashes the default CPU
  and device generators only (which the decoder's dropout draws from, so
  they stay preserved). A region that draws from an explicit
  ``torch.Generator`` (the detection tails' fg/bg sample when proposals
  are not shared) would draw a new sample in the recompute: the same
  shapes, and the gradient of another loss. :func:`remat` sets each
  generator it is given to its state at the forward before the recompute,
  and puts back the state the step had reached after it.

The whole region is recomputed (``checkpoint``'s early stop is off), so
that every rank runs each collective of the region (the halo exchanges of
a row-sharded step, the BatchNorm all-reduce) in the same order, whatever
tensors its shard saves. Under ``torch.no_grad`` (or when grad mode is
off) :func:`remat` only runs the function.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Optional

import torch
import torch.nn as nn
from torch.utils import checkpoint as ckpt


@contextlib.contextmanager
def replayed_bn_stats(bns: List[nn.Module], flags: List[bool]):
    """Train-mode forwards inside the block leave the running statistics
    of the BatchNorms ``bns`` as they are, but take the code path that
    ``flags`` (each one's ``update_stats`` at the region's first forward)
    gave them: a BatchNorm that updated its statistics then writes its EMA
    into copies of its buffers, which the block's end drops."""
    saved = [(m.update_stats, m.running_mean, m.running_var) for m in bns]
    for m, flag in zip(bns, flags):
        m.update_stats = flag
        m.running_mean = m.running_mean.clone()
        m.running_var = m.running_var.clone()
    try:
        yield
    finally:
        for m, (flag, mean, var) in zip(bns, saved):
            m.update_stats, m.running_mean, m.running_var = flag, mean, var


def remat(fn: Callable, *args, module: nn.Module,
          generators: Iterable[Optional[torch.Generator]] = ()):
    """``fn(*args)``, recomputed in the backward. ``module`` holds every
    trainable BatchNorm the region runs (each module with ``update_stats``:
    :class:`afan_torch.models.resnet.BatchNorm`), ``generators`` every
    explicit generator it draws from (None entries are ignored)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    bns = [m for m in module.modules() if hasattr(m, "update_stats")]
    gens = [g for g in generators if g is not None]
    at_forward = [g.get_state() for g in gens]
    flags: List[bool] = []
    first = True

    def region(*a):
        nonlocal first
        if first or not gens:
            first = False
            return fn(*a)
        reached = [g.get_state() for g in gens]
        for g, s in zip(gens, at_forward):
            g.set_state(s)
        try:
            return fn(*a)
        finally:
            for g, s in zip(gens, reached):
                g.set_state(s)

    @contextlib.contextmanager
    def record_flags():
        flags[:] = [m.update_stats for m in bns]
        yield

    def contexts():
        return record_flags(), replayed_bn_stats(bns, flags)

    with ckpt.set_checkpoint_early_stop(False):
        return ckpt.checkpoint(region, *args, use_reentrant=False,
                               context_fn=contexts)
