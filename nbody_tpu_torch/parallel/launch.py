"""Start the ranks of a mesh on this machine.

``shard_map`` needs no launcher: one JAX process drives every device.
torch.distributed runs one process per rank, so ``spawn`` starts them:

    from nbody_tpu_torch.parallel import launch
    results = launch.spawn(fn, 8, backend="gloo", device="cuda",
                           timeout=600, args=(cfg, n_steps))

runs ``fn(mesh, *args)`` on 8 ranks and returns their results in rank
order, moved to the CPU.  `fn` must be importable by module and name
(it is pickled into each rank, which starts from a fresh interpreter):
a module-level function of a module that does not import JAX.

Ranks meet through a ``file://`` rendezvous in a temporary directory
(no network) and each calls ``init_process_group(timeout=...)``.  The
parent waits at most `timeout` seconds for the whole run; a rank that
raises, dies or hangs makes it kill every rank and raise, with the
failing rank's traceback.  On a CUDA mesh the parent builds the CUDA
kernels first, so the ranks sharing a card do not each run nvcc.  A CPU
rank uses its share of the cores (cpu_count // world_size threads).
"""

from __future__ import annotations

import datetime
import io
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nbody_tpu_torch.parallel import comm


def _rank_main(fn, rank, world_size, backend, device, init_method, timeout,
               results, args) -> None:
    """One rank: join the group, build the mesh, run fn, report."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            mesh = comm.make_mesh(world_size, backend, device)
            out = fn(mesh, *args)
            buf = io.BytesIO()
            torch.save(out, buf)
            results.put((rank, True, buf.getvalue()))
        finally:
            dist.destroy_process_group()
    except Exception:
        # the rank's boundary: the traceback goes to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], world_size: int, backend: str, device,
          timeout: float, args: Sequence[Any] = ()) -> List[Any]:
    """fn(mesh, *args) on `world_size` ranks of a mesh on `backend` and
    `device` ("cuda" or "cpu"); their results in rank order.  Raises
    before starting a rank when the machine cannot serve the request
    (comm.check_backend), and when a rank fails or the run outlasts
    `timeout` seconds."""
    dev = comm.check_backend(backend, device, world_size)
    if dev.type == "cuda":
        from nbody_tpu_torch.ops.cuda import build

        build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, failed = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world_size, backend, str(dev), init_method, timeout,
            results, tuple(args))) for rank in range(world_size)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(got) < world_size and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world_size)) - set(got))} "
                        f"did not finish within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                    continue
                (got if ok else failed)[rank] = payload
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.pid is None:         # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                           f"{failed[rank]}")
    return [torch.load(io.BytesIO(got[r]), map_location="cpu",
                       weights_only=False) for r in range(world_size)]
