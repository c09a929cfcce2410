"""Architecture registry of the port.

``get(arch_id)`` returns the full-size ModelConfig; ``get_reduced(arch_id)``
the CPU-testable variant of the same family.  ``--arch <id>`` in the
launcher resolves through this registry.  It holds the architectures the
port runs so far: the dense qwen2.5-3b, chatglm3-6b, gemma-7b and
llama3-405b (the last at reduced width only: it does not fit one card),
mamba2-1.3b (ssm) and zamba2-1.2b (hybrid).  The JAX package's registry
(``repro.configs``) lists the rest.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3-405b": "llama3_405b",
    "gemma-7b": "gemma_7b",
    "chatglm3-6b": "chatglm3_6b",
    "mamba2-1.3b": "mamba2_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get(arch_id: str):
    return _mod(arch_id).full()


def get_reduced(arch_id: str):
    return _mod(arch_id).reduced()


__all__ = ["ARCH_IDS", "get", "get_reduced"]
