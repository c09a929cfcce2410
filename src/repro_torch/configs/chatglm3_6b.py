"""chatglm3-6b [dense] — partial ("2d") RoPE, GQA kv=2, QKV bias.
[arXiv:2406.12793; hf].  ChatGLM rotates only half the head dim —
realized as rope_fraction=0.5.

A copy of ``repro.configs.chatglm3_6b``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "chatglm3-6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab=65024,
        qkv_bias=True, rope_fraction=0.5,
        microbatch=2,
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, q_chunk=16, kv_chunk=16)
