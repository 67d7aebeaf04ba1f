"""A world of ranks on this host, spawned once, that runs jobs.

:class:`LocalWorld` starts ``n`` processes with the ``spawn`` method (as
CUDA requires), joins them in one process group through a ``FileStore``
in a temporary directory, and then runs job after job in all of them:
``world.run(fn, *args)`` calls ``fn(*args)`` on every rank and returns the
ranks' results in rank order. ``fn`` must be a module-level function (it is
pickled by its import path) and its result picklable; a job that raises on
any rank raises ``RuntimeError`` here with that rank's traceback, and the
world is shut down (the next ``run`` starts a new one).

On CUDA, rank ``r`` computes on card ``r % torch.cuda.device_count()``, so
two ranks may share one card; NCCL refuses that, gloo does not. Build the
kernels (``ops.cuda._build.build``) before the first job, so that the
ranks only load them.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback

import torch

__all__ = ["LocalWorld"]


def _rank_main(rank, world_size, backend, device_type, store_path, threads, timeout_s,
               jobs, results):
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except Exception:  # noqa: BLE001 - reported to the caller, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class LocalWorld:
    """``n`` ranks on this host in one process group.

    :param backend: "gloo" or "nccl" (one card per rank).
    :param device_type: "cpu" or "cuda"; CUDA raises without a card.
    :param threads: torch threads per rank (None leaves torch's default).
    :param timeout_s: the process group's timeout, and how long ``run``
        waits for a job.
    """

    def __init__(self, n: int, backend: str = "gloo", device_type: str = "cpu",
                 threads: int | None = 1, timeout_s: float = 300.0):
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LocalWorld(device_type='cuda') needs a CUDA device and none "
                               "is available; pass device_type='cpu' to run on the CPU.")
        self.n, self.backend, self.device_type = n, backend, device_type
        self.threads, self.timeout_s = threads, timeout_s
        self._procs = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="pyvisim_world_")
        store = os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(self.n)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.n, self.backend, self.device_type, store, self.threads,
                              self.timeout_s, self._jobs[r], self._results))
            for r in range(self.n)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results in rank order."""
        if not self._procs:
            self._start()
        for q in self._jobs:
            q.put((fn, args, kwargs))
        out = [None] * self.n
        for _ in range(self.n):
            try:
                rank, ok, value = self._results.get(timeout=self.timeout_s)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                self.close(kill=True)
                raise RuntimeError(f"{fn.__name__}: no result within {self.timeout_s} s "
                                   f"(ranks {dead} exited)") from None
            if not ok:
                # The other ranks may wait in a collective that never comes.
                self.close(kill=True)
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{value}")
            out[rank] = value
        return out

    def close(self, kill: bool = False) -> None:
        """Stop every rank (``kill``: at once) and remove the store."""
        if not self._procs:
            return
        for q, p in zip(self._jobs, self._procs):
            if kill:
                p.kill()
            elif p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
