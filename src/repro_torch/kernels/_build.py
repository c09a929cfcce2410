"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``build/repro_torch/lib<name>.<hash>.so`` under the repository
root (a directory ``.gitignore`` lists), at first use.  The hash covers
the source and the flags, so an edited source never loads a stale
library.  ``build()`` starts one ``nvcc`` for each source that is
missing, all at once, and waits for them; the ptxas report (registers,
shared memory, spills) is kept beside each library as ``.log``.

Pointers and the stream are passed as ``ctypes.c_void_p``: without
declared argument types ctypes would pass them as 32-bit ints.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "decode_attention", "group_pick", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "need the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source not built yet, in parallel.

    Returns ``{name: path of its shared library}``; raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build((name,))[name]))


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_inputs(what: str, *tensors) -> None:
    """Raise on an input a launch cannot take as it is: a DTensor (its
    ``data_ptr()`` is a wrapper's, not the shard's: a sharded path runs
    the plain versions), or, with grad enabled, one that requires grad (a
    ctypes launch writes its output outside autograd, so the output would
    be silently detached; no kernel here has a backward, and training
    runs the plain versions).  ``None`` inputs are skipped."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what}: a DTensor input; the CUDA kernel takes "
                        "plain tensors (sharded models run "
                        "attn_impl='dense')")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: an input requires grad; the CUDA "
                           "kernel has no backward (train with "
                           "attn_impl='dense')")
