"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
parallel attention+mamba heads per layer, ssm_state=16, vocab=32001;
sliding-window attention except 3 global layers [arXiv:2411.13676; hf]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    layer_pattern="sparse_global", local_window=1024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    rope_theta=10000.0, tie_embeddings=True, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, local_window=16, ssm_state=8, ssm_head_dim=32,
    vocab_size=512, dtype=torch.float32)
