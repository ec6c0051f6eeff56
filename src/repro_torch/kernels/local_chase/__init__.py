from repro_torch.kernels.local_chase import ops, ref

__all__ = ["ops", "ref"]
