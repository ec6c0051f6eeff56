"""PyTorch/CUDA port of the distributed list-ranking system.

The port runs on the CUDA device by default; every entry point takes an
explicit ``device`` (tests pass ``device="cpu"``).
"""
