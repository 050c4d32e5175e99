"""Spawn one process per rank and run a function in each.

The reference drives every chip from one process. A PyTorch process drives
its own card, so the port's single-controller entry points (train_splat with
distributed=True) spawn their ranks here. The ranks meet through a file://
rendezvous in a fresh temporary directory (a TCP port could collide between
parallel jobs), set their card before they join the group, and hand their
results back as files in that directory. A rank that raises or dies makes
the call raise; nothing falls back to one process or to the CPU.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 1800  # a collective that waits longer than this raises


def _rank_main(rank: int, fn: Callable, args: tuple, backend: str, devices: Sequence[str],
               run_dir: str, log_queue, num_threads: Optional[int]):
    if num_threads:
        torch.set_num_threads(num_threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(run_dir, 'rendezvous')}",
                            rank=rank, world_size=len(devices),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        log = log_queue.put if (rank == 0 and log_queue is not None) else None
        result = fn(rank, device, log, *args)
        torch.save(result, os.path.join(run_dir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, args: tuple, backend: str, devices: Sequence[str],
                num_threads: Optional[int] = None, log_fn=None) -> list:
    """Run fn(rank, device, log, *args) in len(devices) fresh processes, rank r
    on devices[r], in one process group of `backend`. `fn` must be importable
    (a module-level function of this package); `log` is rank 0's route to
    `log_fn` (None on the other ranks). Pass arrays in `args` as numpy: a
    tensor would cross through shared memory. Returns the ranks' results in
    rank order; raises if a rank fails."""
    run_dir = tempfile.mkdtemp(prefix="tpu_splat_ranks_")
    try:
        log_queue = mp.get_context("spawn").SimpleQueue() if log_fn else None

        def drain():
            while log_queue is not None and not log_queue.empty():
                log_fn(log_queue.get())

        ctx = mp.start_processes(_rank_main, nprocs=len(devices), join=False,
                                 start_method="spawn",
                                 args=(fn, args, backend, list(devices), run_dir, log_queue,
                                       num_threads))
        while not ctx.join(timeout=0.2):
            drain()
        drain()
        # our own files, in a directory this call created
        return [torch.load(os.path.join(run_dir, f"result_{r}.pt"), weights_only=False)
                for r in range(len(devices))]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
