"""Run ``fn(rank, *args)`` in N spawned processes joined by a
``torch.distributed`` process group: the port's data-parallel launcher.

On the card each rank takes its own card (``cuda:<rank>``) and the NCCL
backend; on the CPU the ranks use gloo. ``backend=`` and ``devices=``
override both (the smoke script puts two gloo ranks on ``cuda:0`` to check
the data-parallel step on a one-card machine; no CLI flag reaches them).

The group meets at a free localhost port. ``init_process_group`` and every
collective time out after ``timeout`` seconds, so a rank that hangs makes
its peers' next collective raise. A run has no wall-clock limit of its own
(a training takes hours) unless the caller gives one (``deadline``); once
a rank has returned, the others have ``timeout`` seconds to follow. A rank
that raises or dies makes the launch raise with its traceback (and those
of the ranks its failure broke); the other ranks are stopped. Each rank
runs with one torch thread on the CPU, and with the host's cores shared
out on the card. The launch returns every rank's return value, in rank
order.
"""
from __future__ import annotations

import datetime
import importlib
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT = 1800.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(devices: Sequence[torch.device]) -> str:
    return "nccl" if all(d.type == "cuda" for d in devices) and len(
        {d.index for d in devices}) == len(devices) else "gloo"


def rank_devices(world_size: int, device: Union[str, torch.device]
                 ) -> List[torch.device]:
    """One device per rank: ``cuda:<rank>`` on the card, the CPU
    otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if world_size > torch.cuda.device_count():
            raise ValueError(f"a launch of {world_size} ranks needs "
                             f"{world_size} CUDA devices; "
                             f"{torch.cuda.device_count()} are visible")
        return [torch.device("cuda", r) for r in range(world_size)]
    return [dev] * world_size


def _rank_entry(rank: int, world_size: int, port: int, backend: str,
                devices: Sequence[torch.device], timeout: float,
                fn: Callable, args: tuple, results) -> None:
    try:
        dev = devices[rank]
        torch.set_num_threads(1 if dev.type == "cpu" else max(
            1, (os.cpu_count() or 1) // world_size))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if backend == "nccl":
            # one host: NCCL's bootstrap needs no interface but loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:   # noqa: BLE001 - reported to the parent
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)


def _errors(results, errors: dict, world_size: int,
            wait: float = 3.0) -> str:
    """Every rank's traceback that arrives within ``wait`` seconds of the
    first (a rank that raises often breaks the others' collectives too),
    in rank order."""
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        try:
            r, status, out = results.get(timeout=0.2)
        except queue_mod.Empty:
            continue
        if status == "error":
            errors[r] = out
    return "\n".join(f"rank {r} of {world_size} raised:\n{tb}"
                     for r, tb in sorted(errors.items()))


def launch(fn: Callable, world_size: int, args: tuple = (),
           device: Union[str, torch.device] = "cuda",
           backend: Optional[str] = None,
           devices: Optional[Sequence[Union[str, torch.device]]] = None,
           timeout: float = DEFAULT_TIMEOUT,
           deadline: Optional[float] = None) -> List[Any]:
    """``[fn(0, *args), ..., fn(N-1, *args)]``, each run in a spawned
    process of a group of ``world_size`` ranks; with ``deadline`` the
    launch fails if they have not all returned that many seconds after
    their start. ``fn`` and ``args`` must pickle (``fn`` a module-level
    function of a module that imports no jax)."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else rank_devices(world_size, device)
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices for {world_size} ranks")
    backend = backend or default_backend(devs)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world_size, port, backend, devs, timeout,
                               fn, args, results),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    outs: dict = {}
    failure = None
    start = time.monotonic()
    end = None if deadline is None else start + deadline
    try:
        while len(outs) < world_size and failure is None:
            try:
                r, status, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in outs]
                if dead:
                    # its report may still be in the queue
                    try:
                        r, status, out = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no "
                                   f"report")
                        break
                elif end is not None and time.monotonic() > end:
                    missing = sorted(set(range(world_size)) - set(outs))
                    failure = (f"ranks {missing} did not finish within "
                               f"{end - start:.0f} s of the launch")
                    break
                else:
                    continue
            if status == "error":
                failure = _errors(results, {r: out}, world_size)
            else:
                outs[r] = out
                # the others are at most a collective behind
                follow = time.monotonic() + timeout
                end = follow if end is None else min(end, follow)
        if failure is None:
            for p in procs:
                p.join(timeout=max(end - time.monotonic(), 5.0))
            alive = [i for i, p in enumerate(procs) if p.is_alive()]
            if alive:
                failure = f"ranks {alive} did not exit"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"data-parallel launch failed: {failure}")
    return [outs[r] for r in range(world_size)]


def _cli_rank(rank: int, module: str, argv: List[str]):
    return importlib.import_module(module).main(argv)


def launch_cli(module: str, argv: Sequence[str], world_size: int,
               device: Union[str, torch.device]):
    """``module.main(argv)`` on each of ``world_size`` ranks (one card
    each, or CPU processes); rank 0's return value. The run has no
    wall-clock limit: a rank that hangs fails its peers' collectives after
    :data:`DEFAULT_TIMEOUT` seconds."""
    return launch(_cli_rank, world_size, (module, list(argv)),
                  device=device)[0]
