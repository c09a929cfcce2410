"""The port stands alone: no JAX, no reference package, no silent CPU.

``src/repro_torch`` and ``chip_smoke.py`` import torch and numpy, never
``jax``/``jaxlib`` and nothing of ``repro``; its entry points default to
the CUDA card and raise where there is none.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__", "Registry")):
            # importlib.import_module("x"), and the registries' lazily
            # imported provider module: Registry(kind, "x")
            arg = node.args[-1] if getattr(node.func, "id", "") == \
                "Registry" else node.args[0]
            yield node.lineno, arg.value


def test_port_files_import_no_jax_and_no_reference():
    assert len(PORT_FILES) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in PORT_FILES for line, mod in imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_registry_providers_are_the_port():
    from repro_torch.core import spec
    assert (spec.SCHEDULER_REGISTRY.provider
            == "repro_torch.serving.schedulers")
    assert spec.DISPATCH_REGISTRY.provider == "repro_torch.core.dispatch"
    assert spec.PREDICTOR_REGISTRY.provider == "repro_torch.core.predict"
    assert spec.WORKLOAD_REGISTRY.provider == "repro_torch.core.workload"
    for reg in (spec.SCHEDULER_REGISTRY, spec.DISPATCH_REGISTRY,
                spec.PREDICTOR_REGISTRY, spec.WORKLOAD_REGISTRY):
        # a lookup loads the provider, and every class it registers
        # lives in the port
        assert reg.names()
        assert all(reg.get(n).__module__.startswith("repro_torch.")
                   for n in reg.names()), reg.kind


def test_engines_of_the_reference_are_not_ported():
    from repro_torch import ExperimentSpec
    for engine in ("des", "tick", "vector", "jax"):
        with pytest.raises(ValueError, match="not ported"):
            ExperimentSpec(engine=engine)
    assert ExperimentSpec().engine == "torch"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.launch.fleet\n"
            "import repro_torch.serving.torch_cluster\n"
            "from repro_torch import ExperimentSpec, run_experiment\n"
            "from repro_torch.core.spec import TickWorkloadSpec\n"
            "run_experiment(ExperimentSpec(servers=('cores=2',) * 2,\n"
            "    dispatch='sfs-aware', predictor='history',\n"
            "    workload='bimodal:n=20|zipf:funcs=4'), device='cpu')\n"
            "from repro_torch.serving import Engine, EngineConfig\n"
            "from repro_torch.serving.schedulers import make_scheduler\n"
            "for p in ('sfs', 'cfs', 'fifo', 'srtf'):\n"
            "    make_scheduler(p, 4)\n"
            "Engine(EngineConfig(), device='cpu')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import Engine, EngineConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(configs.get_reduced("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "2"])
    import repro_torch
    from repro_torch.core.spec import ServerSpec, TickWorkloadSpec
    from repro_torch.launch import fleet
    from repro_torch.serving.torch_cluster import TorchCluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchCluster([ServerSpec(cores=2)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.run_experiment(repro_torch.ExperimentSpec(
            servers=("cores=2",), workload=TickWorkloadSpec(n=4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.main(["--engines", "2", "--lanes", "2", "--n", "4"])


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
