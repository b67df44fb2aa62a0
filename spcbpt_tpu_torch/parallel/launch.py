"""One process per rank on this host, joined by torch.distributed.

`spawn(target, world, args, device)` starts `world` processes (start method
`spawn`), each of which initialises the default process group (backend
`nccl` on a CUDA device, `gloo` on the CPU; rendezvous through a `file://`
store in a fresh directory, no TCP port to pick), runs
`target(rank, world, *args)` and reports its result or its traceback. A
rank that raises leaves the others blocked in a collective, so the first
failure, a rank that dies without a report, or the deadline terminates
every rank and raises with the cause. Rank r drives cuda:(r % cards).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

JOIN_S = 10.0       # grace for a rank to exit after it reported
REPORT_GRACE_S = 2.0    # wait for the peers' reports after a failure


def backend_for(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_rank(device: str, rank: int, world: int, init_method: str,
              timeout_s: float) -> torch.device:
    """Joins this process to the default process group as `rank` of
    `world`, every rank on this host; returns the rank's device (a CPU
    rank takes one thread)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = rank_device(device, rank)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev       # NCCL binds the rank to its card
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend_for(device), init_method=init_method, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def _rank_main(target, rank, world, device, init_method, timeout_s, args,
               results):
    try:
        init_rank(device, rank, world, init_method, timeout_s)
        out = target(rank, world, *args)
    except BaseException:
        # reported before the group goes down: the peers' errors follow
        results.put((rank, time.time(), traceback.format_exc()))
        raise
    else:
        results.put((rank, None, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target, world: int, args: tuple = (), device: str = "cpu",
          timeout_s: float = 600.0, rendezvous_dir: str | None = None):
    """Runs target(rank, world, *args) on `world` ranks; returns the list of
    their results in rank order. `target` must be a module-level function
    and its arguments and result picklable; return numpy arrays, not
    tensors (a tensor crosses as shared memory of a process that exits)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="spcbpt_dist_", dir=rendezvous_dir)
    init = "file://" + os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world, device, init, timeout_s,
                               args, results)) for r in range(world)]
    done, failed = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(done) < world and not failed:
            try:
                rank, failed_at, out = results.get(timeout=0.5)
                if failed_at is None:
                    done[rank] = out
                else:
                    failed[rank] = (failed_at, out)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in done]
            if dead and results.empty():
                failed.update({r: (time.time(), f"rank {r} exited with code "
                                   f"{procs[r].exitcode} without a report")
                               for r in dead})
            elif time.monotonic() > deadline:
                failed[-1] = (time.time(), f"deadline of {timeout_s} s "
                              f"passed with ranks {sorted(done)} of {world} "
                              "done")
        # the peers of a failed rank report their own errors soon after
        end = time.monotonic() + REPORT_GRACE_S
        while failed and time.monotonic() < end:
            try:
                rank, failed_at, out = results.get(timeout=0.2)
            except queue.Empty:
                continue
            if failed_at is not None:
                failed[rank] = (failed_at, out)
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if not failed:
                p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
            p.join(JOIN_S)
        shutil.rmtree(store_dir, ignore_errors=True)
    if failed:
        # the earliest failure is the cause; the later ones its echo
        first = min(failed, key=lambda r: failed[r][0])
        raise RuntimeError(f"rank {first} failed first (of {len(failed)} "
                           f"reported):\n{failed[first][1]}")
    return [done[r] for r in range(world)]
