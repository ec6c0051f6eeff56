"""Blockwise forward attention (GQA, causal and sliding-window masks,
logit soft-capping, per-batch query offsets) for the LM serving path."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
