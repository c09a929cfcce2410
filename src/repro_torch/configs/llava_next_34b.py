"""llava-next-34b [vlm] — decoder backbone with anyres vision-prefix stub.
[hf:llava-hf/llava-v1.6-*]

The backbone only; the vision tower is a stub: the first ``n_prefix``
positions (576 = one 24x24 base tile; anyres adds tiles, which only
changes n_prefix) may take precomputed patch embeddings
(``repro_torch.models.frontends.synth_vision_embeds``).

A copy of ``repro.configs.llava_next_34b``. The full config serves from
an int8 KV cache with per-token-head scales.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llava-next-34b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab=64000,
        rope_theta=5_000_000.0, n_prefix=576,
        fsdp=True, microbatch=4,
        kv_cache_dtype="int8",
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_prefix=8, microbatch=1,
        q_chunk=16, kv_chunk=16, kv_cache_dtype="bfloat16")
