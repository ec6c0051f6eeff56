"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000; llama2-arch small [arXiv:2401.02385; hf]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="decoder",
    num_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000,
    rope_theta=10000.0, tie_embeddings=False, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, dtype=torch.float32)
