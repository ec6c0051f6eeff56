"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8)
d_ff=512, MoE 32 experts top-8, vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="decoder",
    num_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    moe=True, num_experts=32, top_k=8,
    rope_theta=10000.0, tie_embeddings=True, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=96, n_heads=4, n_kv_heads=2, head_dim=24,
    d_ff=64, num_experts=8, top_k=2, vocab_size=512, dtype=torch.float32)
