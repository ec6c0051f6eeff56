"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048,
MoE 384 experts top-8 (+1 shared), vocab=163840 — trillion-param MoE
(paper-table) [arXiv:2501.kimi2; unverified]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="decoder",
    num_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    moe=True, num_experts=384, top_k=8, num_shared_experts=1,
    rope_theta=50000.0, tie_embeddings=False, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=3, d_model=96, n_heads=4, n_kv_heads=2, head_dim=24,
    d_ff=64, num_experts=8, top_k=2, num_shared_experts=1,
    vocab_size=512, dtype=torch.float32)
