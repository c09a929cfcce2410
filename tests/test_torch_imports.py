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
    """The JAX package's ``jax`` engine is ``torch`` here and raises; its
    ``des`` engine is ported; the default stays ``torch``."""
    from repro_torch import ExperimentSpec
    with pytest.raises(ValueError, match="not ported"):
        ExperimentSpec(engine="jax")
    assert ExperimentSpec(engine="des").engine == "des"
    assert ExperimentSpec().engine == "torch"


def test_tick_and_vector_engines_are_accepted():
    from repro_torch import ExperimentSpec
    for engine in ("tick", "vector", "torch"):
        assert ExperimentSpec(engine=engine).engine == engine
    with pytest.raises(ValueError, match="unknown engine"):
        ExperimentSpec(engine="object")


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.launch.fleet\n"
            "import repro_torch.serving.torch_cluster\n"
            "import repro_torch.serving.cluster\n"
            "import repro_torch.serving.router\n"
            "import repro_torch.serving.vector_cluster\n"
            "import repro_torch.models.frontends\n"
            "import repro_torch.models.moe\n"
            "from repro_torch import ExperimentSpec, run_experiment\n"
            "from repro_torch.core.spec import TickWorkloadSpec\n"
            "for engine in ('torch', 'tick', 'vector'):\n"
            "    run_experiment(ExperimentSpec(engine=engine,\n"
            "        servers=('cores=2',) * 2, dispatch='sfs-aware',\n"
            "        predictor='history',\n"
            "        workload='bimodal:n=20|zipf:funcs=4'), device='cpu')\n"
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


def test_the_des_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.core\n"
            "from repro_torch import ExperimentSpec, run_experiment\n"
            "from repro_torch.core import (FaaSBenchConfig, SimConfig,\n"
            "    generate, metrics, policies, simulate)\n"
            "reqs = generate(FaaSBenchConfig(n_requests=40, cores=4))\n"
            "for p in policies.ALL_POLICIES:\n"
            "    metrics.result_bucket_stats(simulate(reqs,\n"
            "                                         policies.make(p, 4)))\n"
            "run_experiment(ExperimentSpec(engine='des',\n"
            "    servers=('cores=2',) * 2, dispatch='sfs-aware',\n"
            "    predictor='history',\n"
            "    workload=FaaSBenchConfig(n_requests=40, cores=4)),\n"
            "    device='cpu')\n"
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
    for engine in ("torch", "tick", "vector"):
        # the host backends build their engines on the device too
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.run_experiment(repro_torch.ExperimentSpec(
                engine=engine, servers=("cores=2",),
                workload=TickWorkloadSpec(n=4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "2", "--replicas", "2", "--synthetic"])
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


SHARDING_MODULES = ("repro_torch.sharding.plan", "repro_torch.launch.mesh",
                    "repro_torch.launch.dryrun", "repro_torch.launch.train",
                    "repro_torch.configs.shapes", "repro_torch.train.elastic",
                    "repro_torch.train.checkpoint")


def test_the_sharded_modules_load_no_jax():
    """The sharding plan, the meshes, the dry run and the elastic path
    are port files the AST scan covers, and importing them (and tracing
    a reduced dry-run cell on a fake world) loads no JAX."""
    files = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES
             if p.is_relative_to(ROOT / "src")}
    for mod in SHARDING_MODULES:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SHARDING_MODULES)
            + "import torch.distributed as dist\n"
            "from torch.distributed.device_mesh import init_device_mesh\n"
            "from torch.testing._internal.distributed.fake_pg import "
            "FakeStore\n"
            "from repro_torch import configs\n"
            "from repro_torch.launch import dryrun\n"
            "dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
            "                        world_size=4)\n"
            "mesh = init_device_mesh('cpu', (2, 2),\n"
            "                        mesh_dim_names=('data', 'model'))\n"
            "cfg = configs.get_reduced('qwen2.5-3b')\n"
            "specs = configs.input_specs(cfg, 'decode_32k', 4, 16)\n"
            "dryrun._measure(cfg, 'decode_32k', mesh, 'cpu', specs)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sharded_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    from repro_torch.launch import dryrun, train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--mesh", "pod"])
