"""dbrx-132b [moe] — 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base]

A copy of ``repro.configs.dbrx_132b`` without the blocked attention's
chunks (``q_chunk``,
``kv_chunk``). The full config serves from an int8 KV cache with
per-token-head scales. At full width and depth (131.6 B parameters) it
does not fit one card; the port runs it at full width only with its
depth cut.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "dbrx-132b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=0, vocab=100352,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
        fsdp=True, optimizer="adafactor", microbatch=8, grad_accum="fused",
        kv_cache_dtype="int8",
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32),
        microbatch=2, kv_cache_dtype="bfloat16")
