"""seamless-m4t-medium [audio] — enc-dec, 12L each, d_model=1024 16H
(GQA kv=16) d_ff=4096 vocab=256206; modality frontend STUBBED as
precomputed frame embeddings [arXiv:2308.11596; hf]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, num_encoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    prefix_embed_dim=1024,  # audio frame embedding width (stub)
    rope_theta=10000.0, tie_embeddings=True, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=2, num_encoder_layers=2, d_model=96, n_heads=4,
    n_kv_heads=4, head_dim=24, d_ff=192, vocab_size=512,
    prefix_embed_dim=48, dtype=torch.float32)
