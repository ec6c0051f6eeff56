"""Run-time services of the port: fault tolerance (``fault_tolerance``),
the ambient mesh context (``context``: ``MeshCtx``, ``current``,
``use_mesh``) and blockwise int8 compression (``compression``: ``QInt8``,
``quantization_error``, ``compressed_psum``)."""
from repro_torch.runtime import compression
from repro_torch.runtime.compression import (QInt8, compressed_psum,
                                             quantization_error)
from repro_torch.runtime.context import MeshCtx, current, use_mesh

__all__ = ["MeshCtx", "QInt8", "compressed_psum", "compression", "current",
           "quantization_error", "use_mesh"]
