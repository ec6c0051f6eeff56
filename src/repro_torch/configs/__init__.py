"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The JAX package's ten architectures (see DESIGN.md) as data, each with
its full-size CONFIG and a reduced SMOKE config of the same family for
CPU tests. Every one runs in the port: the five dense decoders
(tinyllama, gemma2, qwen2.5, phi4-mini, pixtral), the MoE decoders
(granite-moe, kimi-k2), mamba2-130m, hymba-1.5b and the encoder-decoder
seamless-m4t-medium.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "gemma2-2b": "gemma2_2b",
    "qwen2.5-14b": "qwen2_5_14b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "pixtral-12b": "pixtral_12b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-130m": "mamba2_130m",
}


def list_archs() -> list[str]:
    return list(_ARCHS)


def get_config(arch: str, smoke: bool = False):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
