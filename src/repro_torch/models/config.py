"""ModelConfig — one dataclass describing every assigned architecture family.

``family`` selects the block structure:
  dense  — pre-norm decoder blocks (GQA attention + gated MLP)
  moe    — dense attention + MoE FFN every layer
  ssm    — Mamba2 (SSD) blocks, attention-free
  hybrid — Mamba2 backbone + one *shared* attention block applied every
           ``attn_every`` layers (Zamba2)
  vlm    — dense decoder whose first ``n_prefix`` positions take precomputed
           patch embeddings (frontend stub per the assignment)
  audio  — encoder-only (bidirectional) transformer over precomputed frame
           embeddings (HuBERT backbone; frontend stub)

A copy of ``repro.models.config`` (the JAX package's module) with
``SSMConfig`` and ``MoEConfig`` carried inline, so that nothing here
imports the JAX package.  The training knobs (``remat``, ``microbatch``,
``grad_accum``, ``grad_accum_dtype``, ``optimizer``) are the
reference's, and so are the sharding knobs (``fsdp``: ZeRO-3 weight
sharding over "data"; ``sharding_profile``: the rule set the dry run
picks, ``repro_torch.launch.dryrun.build_plan``); the layer scan and
the blocked attention's chunks are left out.
``attn_impl`` chooses between the plain PyTorch attention (``"dense"``)
and the hand-written kernels (``"kernel"``, which fall back to their
plain versions only for tensors on the CPU); for the ssm and hybrid
families it also chooses the SSD intra-chunk step (the plain einsums,
or the ``ssd_scan`` kernel).  Training runs the plain paths
(``repro_torch.train.step``).  The port runs every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2             # d_inner = expand * d_model
    n_groups: int = 1           # G (B/C groups)
    conv_width: int = 4
    chunk: int = 256            # Q — SSD chunk length
    dt_min: float = 1e-3
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    # attention (ignored for family == "ssm")
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    activation: str = "swiglu"       # swiglu | geglu
    qkv_bias: bool = False
    rope_fraction: float = 1.0       # 0.5 => partial rotary (ChatGLM "2d")
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False        # Gemma: scale embeds by sqrt(d)
    # family extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0              # hybrid: shared attn every k ssm layers
    n_prefix: int = 0                # vlm: vision-embedding positions
    # ---- attention implementation and dtypes (not architecture) ----
    attn_impl: str = "kernel"        # dense | kernel
    # ---- training (repro_torch.train) ----
    remat: str = "block"             # none | block: recompute each layer
    microbatch: int = 1              # microbatches per train step
    # grad accumulation over microbatches:
    #   scan   — each microbatch's gradient, scaled by 1/n, added to a
    #            buffer in grad_accum_dtype
    #   unroll — the same (the reference's unrolled loop)
    #   fused  — one backward per microbatch into .grad, in the
    #            parameters' dtype (no separate buffer)
    grad_accum: str = "scan"
    grad_accum_dtype: str = "float32"   # float32 | bfloat16 (scan/unroll)
    optimizer: str = "adamw"         # adamw | adafactor
    fsdp: bool = False
    # sharding profile over the fixed (pod, data, model) mesh:
    #   tp_sp     -- tensor parallel on "model" + Megatron sequence
    #                parallelism (baseline)
    #   fsdp_only -- no tensor parallelism: batch and ZeRO-3 weight shards
    #                span data x model
    #   fsdp_ep   -- fsdp_only with the experts on "model"
    sharding_profile: str = "tp_sp"
    # dtype of parameters and activations, and of the KV cache unless
    # kv_cache_dtype is "int8"
    dtype: str = "bfloat16"
    # KV-cache storage: "bfloat16" keeps the model's dtype; "int8" stores
    # int8 keys and values with per-token-head float32 scales (halves the
    # bytes a decode step reads).  The hybrid family ignores it.
    kv_cache_dtype: str = "bfloat16"

    def __post_init__(self):
        assert self.family in ("dense", "moe", "ssm", "hybrid", "vlm",
                               "audio"), self.family
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            assert self.n_heads > 0 and self.head_dim > 0
            assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm is not None
        if self.family == "moe":
            assert self.moe is not None
        if self.attn_impl not in ("dense", "kernel"):
            raise ValueError(f"attn_impl must be 'dense' or 'kernel', "
                             f"got {self.attn_impl!r}")
        if self.kv_cache_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bfloat16' or "
                             f"'int8', got {self.kv_cache_dtype!r}")
        for name, allowed in (("remat", ("none", "block")),
                              ("grad_accum", ("scan", "unroll", "fused")),
                              ("grad_accum_dtype", ("float32", "bfloat16")),
                              ("optimizer", ("adamw", "adafactor")),
                              ("sharding_profile",
                               ("tp_sp", "fsdp_only", "fsdp_ep"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        if self.microbatch < 1:
            raise ValueError(f"microbatch must be at least 1, got "
                             f"{self.microbatch}")

    @property
    def causal(self) -> bool:
        return self.family != "audio"

    @property
    def has_decode(self) -> bool:
        return self.family != "audio"

    @property
    def int8_cache(self) -> bool:
        """Whether the serving cache holds int8 keys and values."""
        return self.kv_cache_dtype == "int8" and self.family != "hybrid"

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
