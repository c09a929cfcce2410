"""hubert-xlarge [audio] — encoder-only backbone (w2v2 arch), frontend stub.
[arXiv:2106.07447]

``forward`` takes precomputed frame embeddings [B, S, d_model] (the conv
feature encoder is the stubbed frontend,
``repro_torch.models.frontends.synth_audio_frames``).  Encoder-only:
attention is not causal and there is no cache or decode step.

A copy of ``repro.configs.hubert_xlarge``.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "hubert-xlarge"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, vocab=504,
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64, q_chunk=16, kv_chunk=16)
