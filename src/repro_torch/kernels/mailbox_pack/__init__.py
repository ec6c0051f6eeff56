"""Fused wire-packing + mailbox bucket-scatter kernel (exchange layer)."""
from repro_torch.kernels.mailbox_pack.ops import mailbox_pack  # noqa: F401
