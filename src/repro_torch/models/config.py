"""Model configuration: the fields of ``repro.models.config.ModelConfig``,
with torch dtypes in place of ``jax.numpy`` ones.

The port runs the architectures listed in :mod:`repro_torch.configs`, but the
dataclass keeps every field of the reference so that a configuration and its
``reduced()`` variant compare field for field with the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio | mlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0
    attn_logit_softcap: float = 0.0

    # mlp flavour
    mlp_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    norm_position: str = "pre"
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    top_k: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    moe_local_dispatch: bool = False

    # SSM (rwkv6 / mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0                 # rwkv6 / mamba2 heads (0 -> derive)
    ssm_expand: int = 2
    conv_dim: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2)
    shared_attn_positions: Tuple[int, ...] = ()

    # VLM
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    # audio
    encoder_layers: int = 0
    n_audio_frames: int = 0

    # objective / head
    objective: str = "clm"
    tie_embeddings: bool = True
    mlm_mask_rate: float = 0.15

    max_seq_len: int = 131072
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    scan_unroll: bool = False
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU-test variant of the same family: 2 layers, d_model <= 256,
        the same rules as the reference's ``reduced()``."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if self.n_kv_heads < self.n_heads:
            n_kv = max(1, n_heads // 2)
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads if n_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            max_seq_len=2048,
            remat=False,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=2)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_heads=0)
        if self.ssm_heads and not self.ssm_state:   # rwkv6
            kw.update(ssm_heads=0)
        if self.shared_attn_positions:
            kw.update(shared_attn_positions=(1,))
        if self.cross_attn_every:
            kw.update(cross_attn_every=2, n_image_tokens=16)
        if self.encoder_layers:
            kw.update(encoder_layers=2, n_audio_frames=32)
        return self.replace(**kw)
