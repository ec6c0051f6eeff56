"""mamba2-130m [ssm] — 24L d_model=768, attention-free SSD
(state-space duality), ssm_state=128, vocab=50280
[arXiv:2405.21060; unverified]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="mamba",
    num_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, ssm_chunk=256,
    tie_embeddings=True, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=64, ssm_state=16, ssm_head_dim=32,
    vocab_size=512, ssm_chunk=16, dtype=torch.float32)
