"""gemma-7b [dense] — GeGLU, head_dim=256, tied embeddings.  [arXiv:2403.08295]

A copy of ``repro.configs.gemma_7b``. The full config serves from an
int8 KV cache with per-token-head scales.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000,
        activation="geglu", tie_embeddings=True, embed_scale=True,
        # 256k-vocab logits in fp32 dominate transient memory — microbatch
        microbatch=4,
        kv_cache_dtype="int8",
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, vocab=512, q_chunk=16, kv_chunk=16,
        kv_cache_dtype="bfloat16")
