"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend STUBBED as precomputed patch
embeddings + mistral-nemo-style decoder
[hf:mistralai/Pixtral-12B-2409; unverified]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="decoder",
    num_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    prefix_embed_dim=1024,  # vision encoder width (stub)
    rope_theta=1000000.0, tie_embeddings=False, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, prefix_embed_dim=48, dtype=torch.float32)
