"""mamba2-1.3b [ssm] — attention-free, SSD (state-space duality).
[arXiv:2405.21060]

A copy of ``repro.configs.mamba2_1_3b``.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

ARCH_ID = "mamba2-1.3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=48, d_model=2048, vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
        microbatch=2, fsdp=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=8, chunk=16))
