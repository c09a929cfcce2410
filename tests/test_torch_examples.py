"""The port's examples (``examples/*_torch.py``) against the JAX
package's: each host example prints the reference script's numbers, and
``serve_sfs_torch.py --reduced --device cpu`` the reference's schedule
summary (requests, ticks, median turnaround, RTE share and lane
switches per policy), once wall times are masked.

All eight scripts run as subprocesses at once (one OpenMP thread each),
started by a module fixture: the discrete-event examples take several
seconds of host Python apiece.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
NAMES = ("quickstart", "overload_demo", "cluster_demo", "serve_sfs")
PORT_ARGS = {"serve_sfs": ["--reduced", "--device", "cpu"]}
WALL = re.compile(r"\(\d+\.\ds wall\)")


@pytest.fixture(scope="module")
def outputs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {}
    for name in NAMES:
        for side, script, args in (
                ("port", EX / f"{name}_torch.py", PORT_ARGS.get(name, [])),
                ("ref", EX / f"{name}.py", [])):
            procs[name, side] = (script, subprocess.Popen(
                [sys.executable, str(script), *args], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    try:
        for key, (script, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"{script}: {stderr[-3000:]}"
            out[key] = body(script, stdout)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return out


def body(script: Path, stdout: str) -> list:
    """The lines a script prints after its own docstring, wall times
    masked."""
    doc = ast.get_docstring(ast.parse(script.read_text()), clean=False)
    assert stdout.startswith(doc + "\n"), script
    return [WALL.sub("(wall)", line)
            for line in stdout[len(doc) + 1:].splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "overload_demo",
                                  "cluster_demo"])
def test_host_example_prints_the_reference_numbers(outputs, name):
    port, ref = outputs[name, "port"], outputs[name, "ref"]
    assert len(ref) >= 5
    assert port == ref


def test_serve_sfs_reduced_prints_the_reference_schedule(outputs):
    """The same summary line per policy; the port adds a line of model
    calls and kernel launches, and on the CPU no kernel launches."""
    port, ref = outputs["serve_sfs", "port"], outputs["serve_sfs", "ref"]
    calls = [line for line in port if "kernel launches:" in line]
    assert [line for line in port if line not in calls] == ref
    summary = [line for line in ref if "requests in" in line]
    assert [line.split(":")[0].strip() for line in summary] == ["sfs", "cfs"]
    assert all(line.startswith("sfs : 40 requests") or
               line.startswith("cfs : 40 requests") for line in summary)
    assert len(calls) == 2
    assert all(line.endswith("flash_attention 0, decode_attention 0")
               and " on cpu;" in line for line in calls)
