"""Deterministic, shardable synthetic data pipeline.

Produces packed LM batches (tokens/labels + document metadata from the
list-ranking packer) with a stateless index->batch mapping, so any step
can be regenerated after restart (the checkpoint stores only the step).

The token stream is a seeded PRNG "corpus" of documents with log-normal
lengths — enough structure for loss-goes-down end-to-end runs without
shipping a dataset.

The port's copy of the JAX package's ``repro.data.pipeline``: the same
host batches byte for byte; ``device_batch`` moves one to a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import packing


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: float = 350.0
    pack: bool = True


def _docs_for_batch(cfg: DataConfig, step: int) -> list[np.ndarray]:
    rng = np.random.default_rng((cfg.seed, step))
    need = cfg.seq_len * cfg.global_batch
    docs, total = [], 0
    while total < need:
        ln = int(np.clip(rng.lognormal(np.log(cfg.mean_doc_len), 0.7),
                         16, 4 * cfg.mean_doc_len))
        ln = min(ln, need - total) or 1
        # skewed unigram distribution, zipf-ish
        d = (rng.zipf(1.3, size=ln) % (cfg.vocab_size - 2)) + 2
        docs.append(d.astype(np.int32))
        total += ln
    return docs


def global_batch(cfg: DataConfig, step: int, mesh=None):
    """Build batch ``step`` (numpy, host-side). Deterministic in
    (seed, step). Returns dict with tokens/labels (+doc metadata)."""
    docs = _docs_for_batch(cfg, step)
    if cfg.pack:
        packed = packing.pack_documents(docs, cfg.seq_len)
        term, after = packing.segment_metadata(packed, mesh=None)
        doc_id, pos, rem = packing.token_metadata(packed, term, after)
        rows = packed.rows[:cfg.global_batch]
        doc_id = doc_id[:cfg.global_batch]
        if rows.shape[0] < cfg.global_batch:
            padr = cfg.global_batch - rows.shape[0]
            rows = np.pad(rows, ((0, padr), (0, 0)))
            doc_id = np.pad(doc_id, ((0, padr), (0, 0)), constant_values=-1)
        labels = np.where(doc_id >= 0, rows, -100).astype(np.int32)
        return {"tokens": rows.astype(np.int32), "labels": labels}
    flat = np.concatenate(docs)[:cfg.seq_len * cfg.global_batch]
    rows = flat.reshape(cfg.global_batch, cfg.seq_len).astype(np.int32)
    return {"tokens": rows, "labels": rows.copy()}


def device_batch(cfg: DataConfig, step: int, device):
    """The global batch ``step`` as int32 tensors on ``device``."""
    host = global_batch(cfg, step)
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}
