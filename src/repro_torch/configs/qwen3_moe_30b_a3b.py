"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained (d_ff=768).
[hf:Qwen/Qwen3-30B-A3B]

A copy of ``repro.configs.qwen3_moe_30b_a3b``. At full width and depth
it serves in bfloat16 on one 80 GB card (30.5 B parameters).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=0, vocab=151936,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
        fsdp=True, microbatch=2,
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
        microbatch=1, q_chunk=16, kv_chunk=16)
