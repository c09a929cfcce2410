"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block applied
every 6 layers.  [arXiv:2411.15242; hf]

The shared transformer block (attention + MLP, d_ff=8192) reuses one set of
parameters at each application (Zamba2's parameter-sharing memory saving;
the per-invocation LoRA deltas are omitted, as in the reference).

A copy of ``repro.configs.zamba2_1_2b`` without the blocked attention's
chunks (``q_chunk``,
``kv_chunk``).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

ARCH_ID = "zamba2-1.2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2),
        attn_every=6, microbatch=4, fsdp=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, attn_every=2,
        ssm=SSMConfig(d_state=16, head_dim=8, chunk=16))
