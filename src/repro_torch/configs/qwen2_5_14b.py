"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA with QKV bias [hf:Qwen/Qwen2.5-14B; hf]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="decoder",
    num_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True,
    rope_theta=1000000.0, tie_embeddings=False, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, dtype=torch.float32)
