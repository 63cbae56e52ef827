"""Host-stage process parallelism.

The reference parallelizes its host stages with OpenMP (block smoothing
src/smooth.cpp:1904, WFA clustering src/breaks.cpp:198, lace walks
src/main.cpp:622-772); the equivalents here are pure-Python/numpy loops, so
`-t/-T` map to a process pool.  Spawn context (never fork): the main
process holds live JAX runtime threads, and forking a threaded process can
deadlock.  Workers pin JAX_PLATFORMS=cpu: one process per card, since a
JAX process that touches the GPU reserves most of its memory, so a worker
that did so would starve the main process (and each other).
"""
from __future__ import annotations

import atexit
import os
import time
from concurrent.futures import ProcessPoolExecutor

_POOL: ProcessPoolExecutor | None = None
_POOL_SIZE = 0


def _init_worker() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # Detach from the parent's stdio so an inherited pipe can never be
    # held open past the parent's exit even if this worker is wedged.
    # Worker exceptions travel back through the futures channel, not
    # stderr, so nothing user-visible is lost.
    if os.environ.get("SMXG_WORKER_STDIO") != "1":
        try:
            devnull = os.open(os.devnull, os.O_RDWR)
            for fd in (0, 1, 2):
                os.dup2(devnull, fd)
            os.close(devnull)
        except Exception:
            pass


def get_pool(n_workers: int) -> ProcessPoolExecutor:
    """Lazily created, process-wide pool; resized when n changes.

    All workers are force-spawned eagerly inside an env-patch window that
    pins JAX_PLATFORMS=cpu (one process per card, see above): spawn
    snapshots the environment at Process.start(), which 3.12's
    ProcessPoolExecutor calls synchronously inside submit() while below
    max_workers.  After the eager spawn no further processes are ever
    created (spawn context never respawns), so the patch window covers
    every worker's lifetime start.
    """
    global _POOL, _POOL_SIZE
    if _POOL is not None and _POOL_SIZE != n_workers:
        shutdown()
    if _POOL is None:
        import multiprocessing as mp
        saved = {"JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS")}
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            _POOL = ProcessPoolExecutor(
                max_workers=n_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_init_worker)
            # eager spawn: each submit() starts one worker synchronously
            # while the patched env is in effect
            for _ in range(n_workers):
                _POOL.submit(_noop)
            deadline = time.monotonic() + 10.0
            while (len(getattr(_POOL, "_processes", {})) < n_workers
                   and time.monotonic() < deadline):
                _POOL.submit(_noop)
                time.sleep(0.01)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _POOL_SIZE = n_workers
        atexit.register(shutdown)
    return _POOL


def _noop() -> None:
    pass


def shutdown() -> None:
    """Terminate pool workers NOW, escalating to SIGKILL: orphaned spawn
    workers would otherwise outlive the CLI holding its inherited stdio
    pipes open (a parent reading those pipes then blocks forever), and a
    worker wedged in native code may ignore SIGTERM.
    """
    global _POOL, _POOL_SIZE
    if _POOL is not None:
        procs = list(getattr(_POOL, "_processes", {}).values())
        try:
            _POOL.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        for p in procs:
            try:
                p.terminate()
            except Exception:
                pass
        deadline = time.monotonic() + 2.0
        for p in procs:
            try:
                p.join(max(0.0, deadline - time.monotonic()))
            except Exception:
                pass
        for p in procs:
            try:
                if p.is_alive():
                    p.kill()
                    p.join(1.0)
            except Exception:
                pass
        # bounded wait for the manager thread so it can unlink the call
        # queue's semaphores (else resource_tracker warns of a leak)
        try:
            t = getattr(_POOL, "_executor_manager_thread", None)
            if t is not None and t.is_alive():
                t.join(2.0)
        except Exception:
            pass
        try:
            q = getattr(_POOL, "_call_queue", None)
            if q is not None:
                q.close()
                q.join_thread()
        except Exception:
            pass
        _POOL = None
        _POOL_SIZE = 0
        import gc
        gc.collect()  # drop queue finalizers now so their semaphores are
        # unlinked before interpreter teardown


def _warm_task() -> None:
    # front-load the imports a real task would pay at unpickle time
    from ..pipeline import breaks, smooth  # noqa: F401


def warm(n_workers: int) -> None:
    """Fire-and-forget worker boot.  Spawned workers cost ~0.5 s of
    interpreter + import startup; kicking them off at pipeline start
    overlaps that with graph load/prep instead of landing it on the first
    parallel stage's critical path."""
    if n_workers and n_workers > 1:
        pool = get_pool(n_workers)
        for _ in range(n_workers):
            pool.submit(_warm_task)


def chunked(items: list, n_chunks: int) -> list[list]:
    """Split into at most n_chunks contiguous, near-equal chunks."""
    n_chunks = max(1, min(n_chunks, len(items)))
    q, r = divmod(len(items), n_chunks)
    out, pos = [], 0
    for i in range(n_chunks):
        size = q + (1 if i < r else 0)
        out.append(items[pos:pos + size])
        pos += size
    return out
