"""Run a script on several gloo ranks for the port's multi-rank tests."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(script: str, tmp: Path, n: int = 8, timeout: float = 300,
              args=()) -> None:
    """``script`` (its first argument is ``tmp``) on ``n`` gloo ranks,
    one process each with one OpenMP thread, started by
    ``torch.distributed.run`` under a time limit of its own (a hang fails
    this test, not the suite); raises with the ranks' output on
    failure."""
    path = tmp / "worker.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), str(path), str(tmp), *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
