"""RWKV6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, data-dependent
decay WKV recurrence, 32 heads of 64, squared-ReLU channel mix (d_ff=3.5d)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    ssm_heads=32,
    use_rope=False,
    norm_type="layernorm",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    source="arXiv:2404.05892",
)
