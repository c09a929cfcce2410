"""llama3-405b [dense] — GQA (kv=8), 128k vocab.  [arXiv:2407.21783]

A copy of ``repro.configs.llama3_405b`` without the blocked attention's
chunks (``q_chunk``,
``kv_chunk``). The full config serves from an int8 KV cache with
per-token-head scales. At full width it does not fit one card; the port
runs its reduced config.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llama3-405b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab=128256,
        rope_theta=500_000.0,
        fsdp=True, optimizer="adafactor", microbatch=16, grad_accum="fused",
        kv_cache_dtype="int8",
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, microbatch=2, kv_cache_dtype="bfloat16")
