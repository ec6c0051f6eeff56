"""Batched LM serving with continuous batching."""
