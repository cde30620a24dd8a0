"""Gloo ranks in spawned processes, for the tests on the CPU and for several ranks
that share one card (NCCL refuses two ranks on one GPU).

``spawn_ranks(fn, world, args)`` starts ``world`` processes (``spawn``), each of
which joins a gloo group through a ``FileStore`` in a fresh temporary directory
(no TCP port, so parallel test workers cannot collide), calls ``fn(rank, world,
*args)`` and sends its return value back. The group's timeout bounds every
collective, and the parent kills the ranks at the deadline. A rank that raises
fails the whole call with its traceback. Users on several cards launch with
``python -m torch.distributed.run`` instead (``parallel/mesh.py``).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback


def _rank_main(fn, rank: int, world: int, store: str, timeout: float, args, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(2)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            # plain pickle bytes: a tensor put on the queue as it is would travel as
            # a shared-memory handle that dies with this process
            out.put((rank, True, pickle.dumps(fn(rank, world, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world: int, args: tuple = (), timeout: float = 120.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each in its
    own gloo rank. ``fn`` and ``args`` must pickle (a module-level function).
    Raises RuntimeError when a rank fails or the deadline passes."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, timeout, args, out),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + timeout + 60.0   # start-up and the group's own timeout
        try:
            while len(results) + len(errors) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"{world} gloo ranks: no result within {timeout + 60:.0f} s")
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead and out.empty():
                        raise RuntimeError(f"a gloo rank died with exit code {dead[0]}")
                    continue
                if ok:
                    results[rank] = pickle.loads(value)   # written by the rank above
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        finally:
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("a gloo rank failed\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
