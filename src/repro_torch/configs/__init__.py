"""Architecture registry of the port.

``get(arch_id)`` returns the full-size ModelConfig; ``get_reduced(arch_id)``
the CPU-testable variant of the same family.  ``--arch <id>`` in the
launcher resolves through this registry.  It holds every architecture
of the JAX package's registry (``repro.configs``): the dense
qwen2.5-3b, chatglm3-6b, gemma-7b and llama3-405b, the moe
qwen3-moe-30b-a3b and dbrx-132b, mamba2-1.3b (ssm), zamba2-1.2b
(hybrid), llava-next-34b (vlm) and hubert-xlarge (audio).  llama3-405b
and dbrx-132b do not fit one card at full width and depth.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3-405b": "llama3_405b",
    "gemma-7b": "gemma_7b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "mamba2-1.3b": "mamba2_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llava-next-34b": "llava_next_34b",
    "hubert-xlarge": "hubert_xlarge",
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
