"""qwen2.5-3b [dense] — GQA (kv=2), QKV bias.  [hf:Qwen/Qwen2.5-*; hf]

A copy of ``repro.configs.qwen2_5_3b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2.5-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab=151936,
        qkv_bias=True, rope_theta=1_000_000.0,
        microbatch=1,
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, q_chunk=16, kv_chunk=16)
