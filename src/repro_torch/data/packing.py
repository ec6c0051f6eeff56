"""Sequence packing with distributed list ranking (DESIGN.md §3.1).

Packing concatenates variable-length documents into fixed-length rows.
Each document's tokens form a chain of *segments* scattered across
packed rows (and across data shards). Computing per-token metadata —
position-in-document, tokens-remaining (needed for causal masking,
document-boundary resets, and span-corruption objectives) — is exactly
*weighted list ranking* on the segment chains:

  element  = one packed segment,
  succ     = the document's next segment (wherever it landed),
  weight   = segment length,
  rank     = tokens of this document after this segment  (dist-to-
             terminal), and the terminal id identifies the document's
             final segment — i.e. the document itself.

On a real pod the segment chains live sharded exactly like the rows
they sit in, so this runs as a ``rank_list`` call over the data mesh
(γ here = fraction of consecutive segments co-located on a shard — the
paper's locality parameter, controlled by the packer's shard-local
greedy fill). This module provides the instance construction, the
distributed path, and a numpy oracle.

The port's copy of the JAX package's ``repro.data.packing``, on the host,
with the port's ``rank_list_with_stats`` over a virtual-PE mesh (results
brought back to the host) and its own ``sequential.rank_list_seq``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.listrank import rank_list_with_stats
from repro_torch.core.listrank import sequential as seq_lib


@dataclasses.dataclass
class Packed:
    """rows: (R, L) token rows; doc_id / pos_in_doc / remaining: (R, L)."""
    rows: np.ndarray
    segment_doc: np.ndarray     # (n_segments,) document of each segment
    segment_row: np.ndarray     # (n_segments,) row holding the segment
    segment_off: np.ndarray     # (n_segments,) offset within the row
    segment_len: np.ndarray
    succ: np.ndarray            # the list-ranking instance over segments
    weight: np.ndarray


def pack_documents(docs: list[np.ndarray], row_len: int,
                   pad_id: int = 0) -> Packed:
    """Greedy first-fit packing, splitting docs across rows when needed.

    Returns the packed rows plus the segment-chain list-ranking
    instance (succ, weight) over segments in row-major order.
    """
    rows: list[list[int]] = [[]]
    seg_doc, seg_row, seg_off, seg_len = [], [], [], []
    doc_segments: list[list[int]] = []
    for d, doc in enumerate(docs):
        remaining = list(map(int, doc))
        my_segs = []
        while remaining:
            if len(rows[-1]) >= row_len:
                rows.append([])
            space = row_len - len(rows[-1])
            take = remaining[:space]
            remaining = remaining[space:]
            my_segs.append(len(seg_doc))
            seg_doc.append(d)
            seg_row.append(len(rows) - 1)
            seg_off.append(len(rows[-1]))
            seg_len.append(len(take))
            rows[-1].extend(take)
        doc_segments.append(my_segs)
    mat = np.full((len(rows), row_len), pad_id, dtype=np.int32)
    for r, row in enumerate(rows):
        mat[r, :len(row)] = row

    n = len(seg_doc)
    succ = np.arange(n, dtype=np.int32)
    weight = np.zeros(n, dtype=np.int32)
    for segs in doc_segments:
        for a, b in zip(segs[:-1], segs[1:]):
            succ[a] = b
            weight[a] = seg_len[b]  # dist-to-terminal counts tokens after
    return Packed(rows=mat, segment_doc=np.asarray(seg_doc),
                  segment_row=np.asarray(seg_row),
                  segment_off=np.asarray(seg_off),
                  segment_len=np.asarray(seg_len),
                  succ=succ, weight=weight)


def segment_metadata(packed: Packed, mesh=None, **rank_kw):
    """Per-segment (final_segment, tokens_after) via list ranking.

    With ``mesh`` given (a virtual-PE mesh, ``sim_mesh``), runs the
    paper's distributed algorithm over the mesh (``rank_kw`` go to
    ``rank_list_with_stats``, ``device`` among them); otherwise the numpy
    oracle. Returns (term_seg, tokens_after) as numpy arrays.
    """
    n = packed.succ.shape[0]
    if mesh is not None:
        p = mesh.size
        pad = (-n) % p
        succ = np.concatenate([packed.succ,
                               np.arange(n, n + pad, dtype=np.int32)])
        w = np.concatenate([packed.weight, np.zeros(pad, np.int32)])
        sf, rf, _ = rank_list_with_stats(succ, w, mesh, **rank_kw)
        return sf.cpu().numpy()[:n], rf.cpu().numpy()[:n]
    return seq_lib.rank_list_seq(packed.succ, packed.weight)


def token_metadata(packed: Packed, term_seg, tokens_after):
    """Expand segment results to per-token (doc_id, pos_in_doc,
    remaining_after_token) arrays of the packed shape."""
    r, l = packed.rows.shape
    doc_id = np.full((r, l), -1, np.int64)
    pos = np.zeros((r, l), np.int64)
    rem = np.zeros((r, l), np.int64)
    # tokens borne before each segment = doc_len - seg_len - tokens_after
    doc_len = np.zeros(packed.segment_doc.max() + 1 if packed.segment_doc.size else 1,
                       np.int64)
    np.add.at(doc_len, packed.segment_doc, packed.segment_len)
    for s in range(packed.succ.shape[0]):
        row, off, ln = packed.segment_row[s], packed.segment_off[s], packed.segment_len[s]
        d = packed.segment_doc[s]
        before = doc_len[d] - tokens_after[s] - ln
        ar = np.arange(ln)
        doc_id[row, off:off + ln] = d
        pos[row, off:off + ln] = before + ar
        rem[row, off:off + ln] = doc_len[d] - (before + ar) - 1
    return doc_id, pos, rem
