"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671]. A copy of
``repro/configs/qwen2_1_5b.py``.

28 layers, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    window=8192,              # sliding-window decode carve-in for long_500k
    rope_theta=1e6,
    source="arXiv:2407.10671",
))
