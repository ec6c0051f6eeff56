"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
import torch
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="decoder",
    num_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    layer_pattern="local_global", local_window=4096,
    attn_softcap=50.0, final_softcap=30.0, attn_scale=256 ** -0.5,
    post_norms=True, scale_embeddings=True, tie_embeddings=True,
    rope_theta=10000.0, dtype=torch.bfloat16)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, local_window=16, dtype=torch.float32)
