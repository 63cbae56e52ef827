"""Regression tests for pool-worker leaks and the piped-stdout hang.

A `smoothxg_jax.cli -t N` run whose spawn workers outlive it keeps the
parent's inherited stdout/stderr open, so `... 2>&1 | tail` never sees
EOF.  Defenses under test (utils/procpool.py):
  1. workers spawn inside an env-patch window that pins JAX_PLATFORMS=cpu
     (one process per card: a worker must never claim the GPU);
  2. shutdown() escalates terminate() -> kill() with join deadlines;
  3. workers detach their stdio in the initializer.
"""
import os
import subprocess
import sys
import time
import uuid

from smoothxg_jax.utils import procpool

TINY = """H\tVN:Z:1.0
S\t1\tACGTACGTAA
S\t2\tA
S\t3\tC
S\t4\tTTGCATGCTT
L\t1\t+\t2\t+\t0M
L\t1\t+\t3\t+\t0M
L\t2\t+\t4\t+\t0M
L\t3\t+\t4\t+\t0M
P\tx\t1+,2+,4+\t*
P\ty\t1+,3+,4+\t*
"""


def _worker_env_probe():
    import os as _os
    return _os.environ.get("JAX_PLATFORMS")


def _worker_pid():
    import os as _os
    return _os.getpid()


def _pids_with_env_marker(marker: str) -> list[int]:
    hits = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker.encode() in f.read():
                    hits.append(int(pid))
        except OSError:
            continue
    return hits


def test_worker_env_stripped(monkeypatch):
    # a parent pointed at the GPU still spawns CPU-pinned workers, and
    # its own environment is restored after the patch window
    procpool.shutdown()
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    pool = procpool.get_pool(2)
    platforms = pool.submit(_worker_env_probe).result(timeout=60)
    assert platforms == "cpu"
    assert os.environ["JAX_PLATFORMS"] == "cuda"
    procpool.shutdown()


def test_shutdown_kills_workers():
    procpool.shutdown()
    pool = procpool.get_pool(2)
    pids = {pool.submit(_worker_pid).result(timeout=60) for _ in range(8)}
    assert pids
    procpool.shutdown()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        live = [p for p in pids if os.path.exists(f"/proc/{p}")
                and "zombie" not in _stat(p)]
        if not live:
            break
        time.sleep(0.1)
    assert not live, f"pool workers survived shutdown(): {live}"


def _stat(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read()
    except OSError:
        return "zombie"


def test_piped_cli_returns_and_leaves_no_orphans(tmp_path):
    """A piped CLI run with a worker pool must reach EOF promptly and
    leave zero descendant processes behind."""
    gfa = str(tmp_path / "tiny.gfa")
    with open(gfa, "w") as f:
        f.write(TINY)
    out = str(tmp_path / "out.gfa")
    marker = f"SMXG_LEAK_TEST_{uuid.uuid4().hex}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env[marker] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "smoothxg_jax.cli", "-g", gfa, "-o", out,
         "-r", "2", "--no-sgd", "-t", "2", "--engine", "host"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    try:
        out_b, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError("piped CLI invocation hung (stdout never hit EOF)")
    assert proc.returncode == 0, out_b.decode(errors="replace")[-2000:]
    assert os.path.exists(out)
    # no process anywhere may still carry our marker env
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        orphans = _pids_with_env_marker(marker)
        if not orphans:
            break
        time.sleep(0.25)
    assert not orphans, f"orphaned descendants after CLI exit: {orphans}"
