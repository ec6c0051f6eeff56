"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064; RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="decoder",
    num_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064,
    rope_theta=10000.0, tie_embeddings=True, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, dtype=torch.float32)
