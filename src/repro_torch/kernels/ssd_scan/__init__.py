"""The Mamba-2 SSD scan (chunked, with a carried state) for the mamba
family's training forward."""
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
