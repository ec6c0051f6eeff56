"""Input-shape sets for the architectures, as the JAX package's
``repro.configs.shapes``.

Every LM arch is paired with four shapes:
  train_4k     seq_len=4096   global_batch=256  -> train_step
  prefill_32k  seq_len=32768  global_batch=32   -> prefill
  decode_32k   seq_len=32768  global_batch=128  -> decode_step (1 token,
                                                   KV/state at 32k)
  long_500k    seq_len=524288 global_batch=1    -> decode_step; only for
               sub-quadratic archs (ssm/hybrid): pure full-attention
               archs skip it (DESIGN.md §Arch-applicability).

``input_specs(cfg, shape)`` returns fake tensors for every model input
(shapes and dtypes, no storage; see ``params.abstract_params``) plus the
name of the step the dry run drives.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: number of stubbed modality-prefix positions for VLM archs.
VLM_PATCHES = 1024


def applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """Whether (arch, shape) is an assigned cell; reason if not."""
    if shape_name == "long_500k" and cfg.family not in ("mamba", "hybrid"):
        return False, ("long_500k requires sub-quadratic sequence mixing; "
                       f"{cfg.name} is pure full-attention (assignment: skip)")
    return True, ""


def token_count(cfg, shape_name: str) -> int:
    """Processed tokens per step (for MODEL_FLOPS accounting)."""
    s = SHAPES[shape_name]
    if s.kind == "decode":
        return s.global_batch  # one new token per sequence
    n = s.seq_len * s.global_batch
    if cfg.family == "encdec":
        n *= 2  # encoder frames + decoder tokens
    return n


def input_specs(cfg, shape_name: str, mode=None,
                device="cpu") -> tuple[dict, str]:
    """(kwargs of fake tensors for the step, step kind): int32 tokens and
    labels, float32 modality embeddings, an encdec decode's ``enc_out`` in
    the model dtype; created under ``mode`` (a ``FakeTensorMode``, a new
    one when None) on ``device``."""
    if mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
    s = SHAPES[shape_name]
    b, l = s.global_batch, s.seq_len
    i32, f32 = torch.int32, torch.float32

    def arr(shape, dt=i32):
        with mode:
            return torch.empty(shape, dtype=dt, device=device)

    if s.kind == "train":
        if cfg.family == "encdec":
            batch = {"enc_embeds": arr((b, l, cfg.prefix_embed_dim), f32),
                     "tokens": arr((b, l)), "labels": arr((b, l))}
        elif cfg.prefix_embed_dim:  # vlm: patches + text fill seq_len
            npatch = min(VLM_PATCHES, l // 4)
            batch = {"prefix_embeds": arr((b, npatch, cfg.prefix_embed_dim),
                                          f32),
                     "tokens": arr((b, l - npatch)),
                     "labels": arr((b, l))}
        else:
            batch = {"tokens": arr((b, l)), "labels": arr((b, l))}
        return {"batch": batch}, "train"

    if s.kind == "prefill":
        if cfg.family == "encdec":
            batch = {"enc_embeds": arr((b, l, cfg.prefix_embed_dim), f32),
                     "tokens": arr((b, l))}
        elif cfg.prefix_embed_dim:
            npatch = min(VLM_PATCHES, l // 4)
            batch = {"prefix_embeds": arr((b, npatch, cfg.prefix_embed_dim),
                                          f32),
                     "tokens": arr((b, l - npatch))}
        else:
            batch = {"tokens": arr((b, l))}
        return {"batch": batch, "max_seq": l}, "prefill"

    # decode: one new token against a seq_len-deep cache
    out = {"tokens": arr((b, 1)), "max_seq": l}
    if cfg.family == "encdec":
        out["enc_out"] = arr((b, min(l, 32768), cfg.d_model), cfg.dtype)
    return out, "decode"
