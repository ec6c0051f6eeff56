#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

Run from the root of the repository (it imports ``src/repro_torch``):

    python3 chip_smoke.py [--out results.json]

(``python3 tools/phase.py N`` runs phase 6, 7 or one of 16-25 alone.) Phases,
each fatal on failure:

1. the card's name and power limit, torch and CUDA versions; build the
   kernel library from ``src/repro_torch/kernels/csrc`` and time it, and
   print ``nvcc -Xptxas -v``'s registers, shared memory and spills for
   the list-ranking and tensor-core kernels;
2. each CUDA kernel against its plain torch version on the card, at the
   main path's shapes (exact equality), with kernel, plain-version and
   library-call times (median of CUDA-event timings), device times
   (torch.profiler) and the kernel's memory/compute bound: ``local_chase``
   on the main path's doubling input (gamma=1; it must run the steps the
   plain model of its fixed-point exit runs, 4 of 20 at full size) and on
   List(2^24, gamma=0), whose every step changes something;
   ``mailbox_pack`` on a level-0 hop, against its plain version and the
   slot scatter of the path without the kernel;
3. the main path: ``rank_list_with_stats`` on List(2^24, gamma=1) over 16
   virtual PEs with both kernels on — exact against the sequential
   oracle, both kernels launched (counts reset just before the solve),
   then the same instance with float32 0/1 weights, then a warm rerun
   with per-stage wall times;
4. the same solve with both kernels off: identical outputs and counters;
5. two-hop grid routing: n = 2^20 on a 4x4 virtual mesh, kernels on;
6. the tree path: ``treealg.tree_stats`` on ``gen_tree_parents(2^21,
   seed=0)`` over 16 virtual PEs, kernels on (its batched solve ranks
   2 x 2^22 arcs) — depth, subtree size, pre- and postorder exact
   against a host oracle (the numpy ``oracle_tour``, ``rank_list_seq`` of
   both weightings, the closed forms of ``treealg/ops.py``), both kernels
   launched (counts reset just before), a warm rerun with per-stage
   wall and peak memory (the kernels' device time over a call and the
   device's idle share are ``tools/profile_port.py --path tree``'s:
   their profiler windows would cost this script about a minute); then
   kernels off (identical outputs and counters); ``root_tree`` and
   ``solve_forest``
   (64 trees of 2^14 nodes) once each, exact against the oracle;
7. the graph path: ``graphalg.graph_stats`` on ``gen_graph_edges(2^19,
   2^21, seed=0, num_components=4)`` (GNM, average degree 8) over 16
   virtual PEs, kernels on (two solves of 2 x 2^21 arcs) — components
   against ``scipy.sparse.csgraph.connected_components`` (min-id labels),
   the forest's edges, roots and span checked, its statistics against
   the tree oracle on the emitted parent array; the same measurements as
   phase 6 (device time: ``tools/profile_port.py --path graph``), the
   hooking and shortcut rounds, then kernels off;
8. the ``flash_attention`` kernel against its plain version on the card:
   the kernel sweep of ``tests/test_kernels.py`` in float32 (atol 2e-5,
   rtol 1e-4) and bfloat16 (2e-2), then the serving path's shapes in
   bfloat16 (tinyllama heads: prefill Lq=1024 over a 2048-key cache,
   decode Lq=1 at per-slot offsets: the tensor-core kernel and the split-K
   pair) with kernel, plain-version and ``scaled_dot_product_attention``
   times, the SDPA backend that ran, and the kernel's bound;
9. the serving path: ``ServingEngine`` serves 16 requests (prompts of
   32..1024 tokens) with tinyllama-1.1b at full width in bfloat16,
   random weights from a seeded generator, 8 slots, kernels on — every
   request completes, every attention call launched the kernel (counts
   reset just before the run); prefill ms per bucket, decode ms per tick,
   tokens/s and peak memory;
10. kernels on against off at full width in float32 (TF32 off): prefill
   one long prompt and 16 teacher-forced decode steps, logits within
   atol 2e-3, rtol 1e-3; the bfloat16 difference is printed as
   information;
11. the ``ssd_scan`` kernel against its plain version (``ssd_ref``) on the
   card: the kernel sweep of ``tests/test_kernels.py`` in float32 (atol
   1e-5, rtol 1e-4), mamba2-130m's training shape (Bt 8, L 1024, H 24,
   P 64, G 1, N 128, chunk 256) in bfloat16 (2e-2) and float32, and the
   gradient of all six inputs through the autograd.Function against
   autograd through ``ssd_ref`` at that shape; kernel (bfloat16: the
   chunk-parallel tensor-core kernels; float32: the CUDA-core kernel),
   ``ssd_chunked_ref`` and ``ssd_ref`` times and the kernel's bound;
12. the training path: ``launch.train`` trains mamba2-130m at full width
   and depth (24 layers, d_model 768, bfloat16) with kernels on, batch 4
   x 1024 tokens from ``pipeline.global_batch``, 2 AdamW steps — finite
   losses and gradient norms, the last loss below the first, 48
   ``ssd_scan`` launches a step (each layer's forward and its remat
   recompute; counts reset just before); ms per step, tokens/s and peak
   memory;
13. kernels on against off in training: mamba2-130m at full width in
   float32 (TF32 off), the loss of one batch with ``ssd_scan`` against
   ``ssd_chunked_ref`` (1e-4 relative); tinyllama-1.1b at full width and
   2 layers, one train step with ``flash_attention`` on in bfloat16
   (finite loss and gradients, two launches per layer: the forward and
   the remat recompute) and, in float32,
   gradients within atol 2e-3, rtol 1e-3 of the plain path's;
14. recovery: phase 3's solve under a ``SolveSupervisor`` checkpointing
   every level boundary into a fresh temporary directory (its free space
   printed first, at least 4 GiB required; deleted at the end), kernels
   on: (a) straight through, outputs and every counter equal to phase
   3's, one checkpoint per interior boundary (6); (b) preempted after
   descend@1 and resumed from that boundary by a fresh supervisor; (c) a
   PE lost before base@2, restored from the boundary with descend@0 run
   once; (d) a store plane corrupted after descend@0, caught before it is
   checkpointed and recovered from the prep boundary; (e) a forced
   ``gather`` overflow at base@2, where only base@2 re-runs; (f) (b)'s
   checkpoint resumed with kernels off. Every case's outputs equal phase
   3's; ``local_chase`` launches once per executed prep and
   ``mailbox_pack`` at least once per other executed stage (none with
   kernels off); the bytes, snapshot and write seconds of each
   boundary's checkpoint, the supervised warm wall against phase 3's, and
   the resume's wall (restore included) against a full solve;
15. the flight recorder: (a) phase 3's solve with ``telemetry=True``,
   ``stage_counters=True`` and a ``Tracer`` (kernels on): outputs bit
   equal to phase 3's, every counter equal, the per-stage collectives
   those of a traced telemetry-off solve, ``local_chase`` launched once
   and ``mailbox_pack`` as often as in phase 3 (counts reset just
   before); (b) the same with kernels off: its stage records equal (a)'s;
   (c) the span tree — every scheduled stage once, every attempt with a
   finite ``predicted_s`` and a ``collective_count`` equal to its stage's
   ``stage_collectives`` total — written as a Chrome trace under
   ``chiprun_out/`` and read back, then printed with the residual and
   headroom tables; (d) ``tree_stats`` at phase 6's and ``graph_stats``
   at phase 7's configuration, traced with telemetry on: outputs equal
   phases 6 and 7, graph-family records present, the graph call's
   escalations as ``escalate:`` instants and in the headroom rows; (e)
   the cost: (a)'s warm wall against phase 3's (one each), the device
   time of one solve of List(2^20) with
   telemetry on and off (``devtime.kernel_times_over``) and the device
   events added;
16. the ``torch.distributed`` transport (``dist_mesh``): (a) NCCL at
   world size 1 in this process, all 16 PEs on one rank: phase 3's
   solve, kernels on — outputs, every counter and the stage collectives
   equal to phase 3's, ``local_chase`` launched once and ``mailbox_pack``
   as often as in phase 3; the warm wall against phase 3's and the
   seconds in collectives (each timed between two syncs); the NCCL calls
   and device events of one hop's collectives in a profiler window; (b)
   gloo with CUDA tensors: 4 spawned processes on the one card, 4 PEs
   each, the same solve — on every rank outputs, counters and stage
   collectives equal to phase 3's, the launches per rank; cold and warm
   walls and the seconds spent in collectives; (c) ``tree_stats`` and ``graph_stats`` under (b)'s
   layout at 2^18 tree nodes and 2^14 graph nodes, each equal to the
   virtual transport's on the same input. The parent joins its ranks
   with a timeout; any rank's failure fails the phase. No number here
   is communication between cards: there is one card;
17. the SSM serving path: (a) ``flash_attention`` at hymba's heads (Hq
   25, Hkv 5, D 64, window 1024), prefill at Lq = Lk = 2048 and 4096 in
   bf16 and f32 and split-K decode at per-slot offsets around the
   window's edge over 4096 keys, and ``ssd_scan`` at hymba's SSD shape
   (Bt 1, L 4096, H 50, P 64, G 1, N 16, chunk 128) in bf16 and f32,
   each against its plain version, with kernel, plain and (attention)
   masked-SDPA times and the bound; (b) mamba2-130m and (c) hymba-1.5b
   at full width and depth (bf16, kernels on) served through the engine
   (8 slots, 16 requests of 32..1024 and 32..3000 tokens, 32 new tokens
   each; every request answered, every token in the vocabulary; mamba2
   launches no kernel, as the reference serves it, hymba
   ``flash_attention`` on every attention call); prefill ms per bucket,
   decode ms per tick, tokens/s and peak memory; (d) in float32 (TF32
   off), kernels on, the engine's admission (a prefill with the prompt's
   valid length) and 17 teacher-forced decode steps against ``forward``
   (atol 2e-3, rtol 1e-3), and hymba's forward with kernels on against
   off;
18. the MoE FFN and the encoder-decoder: (a) ``flash_attention`` at
   every attention shape of (b) and (c): at seamless-m4t's heads (Hq =
   Hkv = 16, D 64, B 8) in bf16 and f32, the encoder's non-causal
   self-attention over 1024 frames, a cross prefill of 256 target
   positions over 1024 frames, a cross decode of one query over 1000 and
   1024 frames (not a whole number of 64-key tiles, and one), and in bf16
   the decoder's causal self-attention, a prefill of 64 over a 96-key
   cache and a decode at offsets 64 and 95 in it; at granite-moe's heads
   (Hq 16, Hkv 8, D 64) in bf16, the engine's causal prefill at buckets
   128 and 1024 over its 2048-key slot and its split-K decode at eight
   per-slot offsets over 2048 keys; each against its plain version (a
   decode also against its split-and-merge) with kernel, plain and SDPA
   times and the bound; (b) granite-moe-1b at full width and depth
   (bf16, kernels on) served through the engine with phase 17's traffic
   (8 slots, 16 requests of 32..1024 tokens, 32 new each), the
   single-program MoE dispatch on every layer, ``flash_attention``
   exactly 24 x (prefills + ticks); (c) seamless-m4t-medium at full width
   and depth (bf16, kernels on): ``encode`` of 8 x 1024 random frames, a
   prefill of 8 x 64 target tokens (which encodes again, as the
   reference's does), 32 greedy ``decode_step(..., enc_out=)`` steps,
   ``flash_attention`` exactly 12 per encode and 24 per prefill and step;
   ms of each and peak memory (counter reset once the weights and the
   cache are allocated, as in (b)); (d)
   in float32 (TF32 off) at SMOKE width, granite-moe's, kimi-k2's and
   seamless's forward with kernels on against off (atol 2e-3, rtol
   1e-3), and granite-moe's engine tokens at capacity factor 8 (nothing
   dropped) equal to the greedy continuation of its own ``forward``;
19. the mesh context and the expert-parallel MoE (``moe_ffn_ep``): (a)
   one granite-moe-1b MoE layer at full width (bf16, 8 x 1024 tokens, a
   capacity factor at which no expert drops) under virtual ("data",
   "model") meshes (1, 1), (4, 1) and (2, 2) against the dense dispatch
   (bf16 tolerance 2e-2), with ms, device ms, aux, the transport's
   collectives (2 ``psum`` a layer, and 2 ``all_to_all`` where the
   expert axis has more than one PE) and bytes, and no
   ``mailbox_pack`` launch (the reference's ``pallas_pack`` is off
   here); (b) the same layer under a ``DistMesh`` (1, 1) over NCCL at
   world size 1, bit-equal to (a)'s (1, 1), its collectives timed; (c)
   ``launch/train.py --arch granite-moe-1b-a400m --use-kernels`` at full
   width, 3 steps of 4 x 512 tokens under its (1, 1) mesh, ``moe_ffn_ep``
   on every layer and again in its remat recompute, finite losses, ms a
   step, tokens/s and peak memory, beside the same steps without a
   context (the dense dispatch); (d) float32 SMOKE under a (4, 1) mesh:
   ``moe_ffn_ep`` kernels on equal to off and to itself bit for bit, the
   forward on against off within the attention kernel's tolerance;
20. per-rank recovery, the int8 runtime and remat (alone:
   ``tools/phase.py 20``): (a) gloo with CUDA tensors, 2
   spawned ranks of 8 PEs on the card (p = 16), List(2^22, gamma=1),
   kernels on: an unsupervised solve cold and warm, then supervised
   (every boundary kept), preempted on rank 1 alone after descend@0 and
   resumed, a PE of rank 1 lost before base@2, a plane of a PE of rank 1
   corrupted after descend@0, and resumed from the virtual transport's
   checkpoint; every case's outputs and counters equal to the virtual
   transport's solve of the same list, the supervised run's boundary
   checkpoints equal to the virtual transport's byte for byte, the
   virtual transport resuming the ranks' preempted checkpoint; bytes,
   snapshot and write seconds per boundary, walls and launches per rank;
   (b) ``compressed_psum`` on the card equal to the CPU's bit for bit on
   the same inputs, then ``examples/torch_dp_compression.py``'s loop over a
   virtual transport of 8 PEs (final loss against the exact all-reduce's
   and the CPU run's), and one granite-moe-1b step at full width with
   int8 AdamW state (its bytes against float32 state's); (c)
   granite-moe-1b through ``launch/train.py`` at full width, 3 steps of 4
   x 512 tokens under its (1, 1) mesh with remat on and off, and
   hymba-1.5b at full width with remat and int8 state, 2 steps of 2 x 128
   tokens: ms a step, tokens/s, peak memory (the counter reset once the
   weights and the optimizer state are allocated), launches, and
   granite's peak over one forward and backward alone; (d) float32
   SMOKE, kernels on: the losses and every gradient of one step bit-equal
   with remat on and off for mamba2, hymba, granite-moe under a (4, 1)
   mesh and seamless-m4t.
21. the shape-only dry run (``launch/dryrun.py``; alone:
   ``tools/phase.py 21``), which touches no card (its launches and the
   card's allocated bytes unchanged across it): (a) granite-moe-1b's
   launcher step at (1, 1), 4 x 512 tokens, remat on and off, the
   kernels' path and ``launch/train.py``'s ``TrainConfig``: the predicted
   step peak within 10 % of phase 20 (c)'s measured rows, the predicted
   forward-and-backward peak above the weights within 25 % of its
   ``_grad_peak``; (b) tinyllama-1.1b's prefill of 8 x 1024 tokens into
   its cache, no kernels: the dry run's argument bytes equal to the bytes
   of the tensors the real call reads, its peak within 15 % of the
   call's (the counter reset with the inputs allocated), the wall against
   the roofline's bound (no gate); (c) ``examples/torch_trace_solve.py``
   at n = 2^16, p = 8 on the card: the oracle match, the tables, the
   Chrome trace beside phase 15's;
22. the port's examples (alone: ``tools/phase.py 22``): (a)
   ``flash_attention`` at gemma2-2b's heads (Hq 8, Hkv 4, D 256, scale
   256^-0.5, soft-cap 50, causal) over its 8192-key slot in bf16 and f32:
   global and 4096-key-window prefills at Lq = Lk = 8192, a 1024-token
   prefill bucket, split-K decodes at offsets 100, 4095-4097 and 8191 with
   the window on and off, each against its plain version (a decode also
   against its split-and-merge) with kernel, device and plain times, the
   bound (the library call, torch's compiled ``flex_attention``, is
   ``tools/profile_lm_kernels.py``'s); (b) gemma2-2b at
   full width and depth (26 layers, bf16, kernels on) served through
   ``examples/torch_serve_demo.py``'s ``serve``: 8 slots of 8192, 16
   requests of 32..6000 tokens, 32 new each, every request answered,
   ``flash_attention`` exactly 26 x (prefills + ticks); prefill ms per
   bucket, decode ms per tick, tokens/s, p50/p90 latency, peak memory
   (the counter reset with the weights and the cache allocated); (c)
   ``examples/torch_{quickstart,euler_tour,tree_stats,connectivity}.py``
   on the card as written and with ``--kernels``: their checks pass,
   every output and counter bit-equal, ``local_chase`` and
   ``mailbox_pack`` launched with ``--kernels`` only; (d)
   ``examples/torch_train_100m.py`` at its full config with
   ``--use-kernels``: 5 steps of 4 x 512 with a checkpoint, then resumed
   there to step 10 (finite losses, 24 ``flash_attention`` launches a
   step), ms a step, tokens/s, peak memory; then
   ``examples/torch_dp_compression.py``'s wall; (e) float32, TF32 off:
   gemma2-2b at full width with 2 layers, a 6000-token prompt and 8
   teacher-forced steps with kernels on against off (atol 2e-3, rtol
   1e-3), and the SMOKE engine's tokens through ``serve`` equal to its own
   ``forward``'s greedy continuation;
23. the solver's configurations (alone: ``tools/phase.py 23 [n]``), each
   solved through ``rank_list_with_stats`` at p = 16 with both kernels on
   and then off: (a) the paper's Fig 3, ``srs`` and ``doubling`` each
   with direct routing over 16 PEs and two-hop grid routing on a 4x4
   mesh, List(2^22, gamma=1); (b) Fig 4 on a (2, 2, 4) ("node", "row",
   "col") mesh: direct (one hop over three axes), the three-hop grid,
   topology-aware routing (("col",) then ("node", "row"): a hop over two
   axes) and ``auto_indirection`` (the tuner's spec logged), with the
   messages of each phase; (c) Fig 2 at 2^20: gamma 0, 0.5 and 1 with
   local contraction off and on; (d) at 2^19: the faithful reversal,
   the all-gather base, no request dedup, the unpacked wire
   (``local_chase`` only), tuned rulers, ``algorithm="auto"``, capacity
   estimation, and a forest of 64 random lists with int32 and
   integer-valued float32 weights ((c) and (d) cut from 2^22 for the
   phase's time). Each variant's two solves equal
   ``rank_list_seq`` exactly and each other bit for bit with equal
   integer counters, leave dropped, sub_overflow, store_miss and
   undelivered at 0, and launch ``local_chase`` where (and only where)
   local contraction is on and ``mailbox_pack`` where the wire is packed
   (counts reset before each solve); walls, rounds, messages, attempts,
   collectives per stage and launches go to
   ``chiprun_out/chip_smoke_configs.json``;
24. the head-dim-128 decoders (alone: ``tools/phase.py 24``): (a)
   ``flash_attention`` at the heads of qwen2.5-14b, phi4-mini-3.8b and
   pixtral-12b (Hq / Hkv 40 / 8, 24 / 8 and 32 / 8: GQA groups 5, 3 and 4;
   D 128, causal, no window) in bf16 and f32: a prefill at Lq = Lk = 4096,
   a 1024-token prefill bucket over an 8192-key slot and a split-K decode
   of 5 slots over 8192 keys at offsets 0, 1, 4095, 6000 and 8191, each
   against its plain version (a bf16 decode also against its
   split-and-merge) with kernel, device and plain times and the bound
   (SDPA at the same cases is ``tools/profile_lm_kernels.py``'s); (b)
   qwen2.5-14b (its q/k/v biases redrawn as seeded normals x 0.02), (c)
   phi4-mini-3.8b (its tied 200 064-token head) and (d) pixtral-12b at
   full width and depth (bf16, kernels on) served through
   ``examples/torch_serve_demo.py``'s ``serve`` with 22 (b)'s traffic:
   every request answered with tokens in the vocabulary (no padded row of
   the head), ``flash_attention`` exactly layers x (prefills + ticks) and
   no other kernel; prefill ms per bucket, decode ms per tick, tokens/s,
   p50/p90 latency, weight and cache bytes, the init's peak memory and the
   run's (the counter reset with the weights and the cache allocated);
   then pixtral through ``M.prefill`` with 2 x 1024 patch embeddings in
   front of 64 tokens a row into a 2048-position cache and 32 greedy
   ``M.decode_step``s at positions 1088 + i: finite logits, exactly the
   filled positions, 40 x 33 launches; (e) float32, TF32 off: each at full
   width with 2 layers, a 6000-token prompt (pixtral's behind 1024 patch
   embeddings) and 8 teacher-forced steps with kernels on against off
   (atol 2e-3, rtol 1e-3);
25. kimi-k2 at full width (alone: ``tools/phase.py 25``): (a)
   ``flash_attention`` at its heads (Hq 64 over Hkv 8: GQA group 8; D 112,
   scale 112^-0.5, causal, no window) on phase 24 (a)'s cases in bf16 and
   f32, each against its plain version with kernel, device and plain
   times and the bound (SDPA at the same cases is
   ``tools/profile_lm_kernels.py``'s); (b) kimi-k2 at full width and one
   layer of its 61 (bf16, kernels on: a 384-expert top-8 MoE FFN with its
   shared expert, d_model 7168, an untied 163 840-token head) served
   through ``examples/torch_serve_demo.py``'s ``serve`` with 22 (b)'s
   traffic: every request answered with tokens in the vocabulary,
   ``flash_attention`` exactly once a prefill and a tick and no other
   kernel; prefill ms per bucket, decode ms per tick, tokens/s, the init's
   peak memory and the run's (the counter reset with the weights and the
   cache allocated); (c) float32, TF32 off: at full width with 2 layers
   and the experts cut to 64 (top-8 and the shared expert kept: at 384 a
   float32 layer's experts alone take 63 GiB), a 6000-token prompt and 8
   teacher-forced steps with kernels on against off (atol 2e-3, rtol
   1e-3).

The last line of standard output is a one-line JSON verdict; the line
before it lists each kernel's launches and times. Without CUDA, or
without the repository next to it, the script exits non-zero and prints
no verdict.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

N_MAIN, P_MAIN, SEED = 1 << 24, 16, 0
N_GRID = 1 << 20
#: the tree path's nodes; the graph path's nodes (edges: 4x, components 4);
#: halved from 2^22 and 2^20 for the script's time limit
N_TREE, N_GRAPH = 1 << 21, 1 << 19
#: solve_forest's batch in phase 6: trees x nodes
FOREST_TREES, FOREST_NODES = 64, 1 << 14


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, torch, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, torch, expect: dict, reps: int = 10):
    """Device time of one call of ``fn`` (kernels, fills and copies it
    launched, summed; one torch.profiler window of ``reps`` calls, up to
    five windows), or None unless a window saw every call's ``expect``
    ({kernel name: launches per call}, ``devtime.EXPECT``) exactly:
    CUDA-event timing of a wrapper call also holds the host's time to
    launch it, and a window that drops calls would read low."""
    from repro_torch import devtime
    try:
        return devtime.profiled_ms(fn, torch, expect, reps=reps, log=log)[0]
    except Exception as exc:  # the profiler is information here, no gate
        log(f"  (no device time: {type(exc).__name__}: {exc})")
        return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_abs_err(a, b, torch) -> float:
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


#: the kernels whose ptxas report phase 1 prints
PTXAS_KERNELS = ("chase_persistent_kernel", "mailbox_pack_kernel",
                 "flash_fwd_mma_kernel", "flash_fwd_kernel",
                 "flash_decode_split_kernel",
                 "flash_decode_merge_kernel", "ssd_cb_kernel",
                 "ssd_state_kernel", "ssd_pass_kernel",
                 "ssd_chunk_scan_kernel")


def ptxas_summary(log_text: str) -> list[str]:
    """One line per instantiation of a ``PTXAS_KERNELS`` kernel in nvcc's
    ``-Xptxas -v`` output: registers, static shared memory, spill stores
    and loads."""
    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            name = next((k for k in PTXAS_KERNELS if k in mangled), None)
            if name:
                rest = mangled.split(name, 1)[1]
                args = re.findall(r"Li(\d+)E", rest)
                if rest.startswith(("IiE", "IfE")):  # an int / float kernel
                    args = ["int" if rest[1] == "i" else "float"]
                elif rest.startswith("If"):  # <float, D>
                    args = ["float"] + args
                name += f"<{','.join(args)}>" if args else ""
            continue
        if name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, "
                       f"{smem.group(1) if smem else 0} bytes static smem; "
                       f"{spills}")
            name, spills = None, ""
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the repository")
    sys.path.insert(0, str(SRC))
    t0 = time.time()
    run(torch.device("cuda", 0), N_MAIN, N_GRID, args.out, t0)


def run(dev, n_main: int, n_grid: int, out_path=None, t_start=None,
        n_tree: int = N_TREE, n_graph: int = N_GRAPH) -> None:
    """Phases 1-25 on device ``dev`` at ``n_main`` / ``n_grid`` list
    elements, ``n_tree`` tree nodes and ``n_graph`` graph nodes."""
    import torch
    from repro_torch.core.listrank import (IndirectionSpec, ListRankConfig,
                                           instances, rank_list_seq,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch import devtime
    from repro_torch.core.listrank import api, exchange, local
    from repro_torch.kernels import build
    from repro_torch.kernels.local_chase import ops as lc_ops, ref as lc_ref
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.kernels.mailbox_pack import ref as mp_ref

    results: dict = {"phase_s": {}}
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        """Log the seconds since the last lap (phases 1-14; the later
        phases time themselves)."""
        now = time.perf_counter()
        results["phase_s"][what] = now - t_lap[0]
        log(f"{what}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    # ---------------------------------------------------------- phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    # the host's oracles, made in worker processes while the card works:
    # the main path's (taken before phase 3 checks against it), then
    # phase 23's instances
    pool = host_pool()
    oracle = pool.submit(_config_instance_child, ("list", n_main, 1.0))
    config_made = config_futures(pool, CONFIG_N)
    t0 = time.time()
    build.load_library()
    results["build_s"] = time.time() - t0
    log(f"phase 1: kernel library built and loaded in "
        f"{results['build_s']:.1f} s")
    if "log" in build.build_info:
        log("phase 1: ptxas (nvcc -Xptxas -v) for the list-ranking, "
            "attention and tensor-core kernels; the attention and "
            "tensor-core kernels' tiles are dynamic shared memory, sized at "
            "launch:")
        for line in ptxas_summary(build.build_info["log"]):
            log("  " + line)
        log(f"  ssd_scan bf16 at mamba2-130m's shape needs "
            f"{build.load_library().ssd_scan_bf16_smem_bytes(128, 64, 256)}"
            f" bytes of dynamic shared memory (the largest of its kernels)")
    else:
        log("phase 1: library found prebuilt (no ptxas report)")

    # the main path's instance and capacities (host side)
    t0 = time.time()
    succ_np, rank_np = instances.gen_list(n_main, gamma=1.0, seed=1)
    log(f"instance List({n_main}, gamma=1): {time.time() - t0:.1f} s on the "
        f"host (its oracle in a worker process)")
    m = n_main // P_MAIN
    mesh = sim_mesh(P_MAIN)
    plan = exchange.MeshPlan.from_mesh(mesh, ("pe",), device=dev)
    cfg_on = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    owners = np.arange(n_main) // m
    term_bound = int(np.bincount(owners[succ_np == np.arange(n_main)],
                                 minlength=P_MAIN).max())
    spec0 = api.build_specs(cfg_on, plan, m, n_main, term_bound)[0]

    lap("phase 1 and the instance")

    # ---------------------------------------------------------- phase 2
    kernels = []
    succ_d = torch.from_numpy(succ_np).reshape(P_MAIN, m).to(dev)
    rank_d = torch.from_numpy(rank_np).reshape(P_MAIN, m).to(dev)
    base = plan.my_id() * m
    succ_l, dist0, steps, _ = local.chase_input(succ_d, rank_d, base, m)
    errs, times = [], {}
    elems = P_MAIN * m

    def check_chase(succ_l, d, steps, what):
        s_k, d_k = lc_ops.local_chase(succ_l, d, steps)
        run = lc_ops.STEPS_RUN.tolist()
        s_p, d_p = lc_ref.local_chase_ref(succ_l, d, steps)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_p) and torch.equal(
                d_k.view(torch.int32), d_p.view(torch.int32))):
            fail(f"local_chase ({what}) differs from its plain version")
        errs.append(max(max_abs_err(s_k, s_p, torch),
                        max_abs_err(d_k, d_p, torch)))
        t = (time_ms(lambda: lc_ops.local_chase(succ_l, d, steps), torch),
             time_ms(lambda: lc_ref.local_chase_ref(succ_l, d, steps),
                     torch),
             device_ms(lambda: lc_ops.local_chase(succ_l, d, steps), torch,
                       devtime.EXPECT["local_chase"]),
             devtime.queued_ms(
                 lambda: lc_ops.local_chase(succ_l, d, steps), torch))
        log(f"phase 2: local_chase {what} B={P_MAIN} m={m}: equal; steps run "
            f"per row {run} of {steps}; kernel {t[0]:.4f} ms (device "
            f"{fmt_ms(t[2])}, queued {fmt_ms(t[3])}), plain {t[1]:.3f} ms")
        return t, max(run)

    # the plain model of the kernel's schedule says how many steps each
    # row's group runs (the 4th is the first unchanged one at full size)
    _, _, want_run = lc_ref.local_chase_fixed_point_ref(
        succ_l.cpu(), dist0.cpu(), steps,
        lc_ops.rows_per_group(P_MAIN, m, 4, dev))
    for dt in (torch.int32, torch.float32):
        times[dt], run = check_chase(succ_l, dist0.to(dt).contiguous(), steps,
                                     f"gamma=1 {dt}")
        if lc_ops.STEPS_RUN.tolist() != want_run.tolist():
            fail(f"local_chase ran {lc_ops.STEPS_RUN.tolist()} "
                 f"steps; its plain model {want_run.tolist()}")
    steps_run = run
    if n_main == N_MAIN and steps_run != 4:
        fail(f"local_chase ran {steps_run} steps on the main path's input, "
             f"where the 4th is the first that changes nothing")
    # the worst case: each PE holds one chain of m, all 20 steps change it
    succ_0, rank_0 = instances.gen_list(n_main, gamma=0.0, seed=1)
    succ_l0, dist_0, _, _ = local.chase_input(
        torch.from_numpy(succ_0).reshape(P_MAIN, m).to(dev),
        torch.from_numpy(rank_0).reshape(P_MAIN, m).to(dev), base, m)
    times["gamma0"], run0 = check_chase(succ_l0, dist_0, steps,
                                        "gamma=0 torch.int32")
    if run0 != steps:
        fail(f"local_chase stopped after {run0} of {steps} steps on the "
             f"gamma=0 input, whose every step changes something")
    del succ_0, rank_0, succ_l0, dist_0
    # inputs read once, outputs written once; one add per element per step
    # that ran
    lc_bound, lc_by = devtime.bound_ms(16 * elems, steps_run * elems)
    log(f"local_chase bound (inputs read once, outputs written once): "
        f"{lc_bound:.4f} ms by {lc_by}")
    kernels.append({
        "name": "local_chase", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/local_chase.cu",
        "replaces": "src/repro/kernels/local_chase/kernel.py:27",
        "launches": 0, "max_abs_err": max(errs),
        "ms": times[torch.int32][0], "plain_ms": times[torch.int32][1],
        "device_ms": times[torch.int32][2],
        "queued_ms": times[torch.int32][3], "steps_run": steps_run,
        "ms_float32": times[torch.float32][0],
        "plain_ms_float32": times[torch.float32][1],
        "ms_gamma0": times["gamma0"][0], "plain_ms_gamma0": times["gamma0"][1],
        "device_ms_gamma0": times["gamma0"][2], "steps_run_gamma0": run0,
        "bound_ms": lc_bound, "bound_by": lc_by, "library_ms": None})

    # one chase-round hop at level 0: Q = queue + inbox + spawn window
    s_hop = P_MAIN
    cap = spec0.mail_caps[0]
    n_rows = s_hop * cap
    q = spec0.queue_cap + n_rows + spec0.spawn_window
    g = torch.Generator(device=dev).manual_seed(7)
    valid = torch.rand((P_MAIN, q), device=dev, generator=g) < (
        spec0.r_static / q)
    target = torch.randint(0, n_main, (P_MAIN, q), device=dev, generator=g,
                           dtype=torch.int32)
    payload = {"target": target,
               "ruler": torch.randint(0, n_main, (P_MAIN, q), device=dev,
                                      generator=g, dtype=torch.int32),
               "weight": torch.rand((P_MAIN, q), device=dev, generator=g),
               "_dest": (target // m).to(torch.int32)}
    order, row, col, fits, _, skey = exchange._bucket_indices(
        payload["_dest"], valid, s_hop, cap)
    slots = exchange.unpermute(order, row * cap + col).contiguous()
    wf = exchange.WireFormat.from_payload(payload)
    cols = [c.contiguous() for c in wf.payload_columns(payload)]
    out_k = mp_ops.mailbox_pack(cols, order, skey, s_hop, cap)
    out_p = mp_ref.mailbox_pack_sorted_ref(cols, order, skey, s_hop, cap)
    # the scatter formulation (the exchange's path without the kernel)
    stacked = wf.planes(payload, valid)
    out_s = mp_ref.mailbox_pack_ref(stacked, slots, n_rows)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        fail("mailbox_pack differs from its plain version")
    if not torch.equal(out_k, out_s):
        fail("mailbox_pack differs from the slot scatter")
    w = stacked.shape[1]
    keep = (slots >= 0) & (slots < n_rows)
    lib_idx = (torch.arange(P_MAIN, device=dev)[:, None, None],
               torch.arange(w, device=dev)[None, :, None],
               torch.where(keep, slots, n_rows).long()[:, None, :])
    lib_buf = torch.empty((P_MAIN, w, n_rows + 1), dtype=torch.int32,
                          device=dev)

    def library_call():
        lib_buf.zero_()
        lib_buf.index_put_(lib_idx, stacked)

    library_call()
    if not torch.equal(lib_buf[:, :, :n_rows], out_p):
        fail("the index_put_ yardstick computes another function")

    def kernel_call():
        return mp_ops.mailbox_pack(cols, order, skey, s_hop, cap)

    mp_ms = time_ms(kernel_call, torch)
    mp_dev = device_ms(kernel_call, torch, devtime.EXPECT["mailbox_pack"])
    mp_queued = devtime.queued_ms(kernel_call, torch)
    mp_plain = time_ms(lambda: mp_ref.mailbox_pack_sorted_ref(
        cols, order, skey, s_hop, cap), torch)
    mp_lib = time_ms(library_call, torch)
    shipping = int(fits.sum())
    mp_bound, mp_by = devtime.bound_ms(
        devtime.pack_bytes(P_MAIN, w, n_rows, shipping), 0)
    log(f"phase 2: mailbox_pack p={P_MAIN} W={w} Q={q} n_rows={n_rows} "
        f"shipping={shipping}: equal to the sorted gather and to the slot "
        f"scatter; kernel {mp_ms:.4f} ms (device {fmt_ms(mp_dev)}, queued "
        f"{fmt_ms(mp_queued)}), plain "
        f"{mp_plain:.3f} ms, zero fill + index_put_ {mp_lib:.3f} ms, bound "
        f"{mp_bound:.4f} ms (the buffer written once, each shipping "
        f"message's payload words and index read once)")
    kernels.append({
        "name": "mailbox_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mailbox_pack.cu",
        "replaces": "src/repro/kernels/mailbox_pack/kernel.py:30",
        "launches": 0, "max_abs_err": max_abs_err(out_k, out_p, torch),
        "ms": mp_ms, "plain_ms": mp_plain, "device_ms": mp_dev,
        "queued_ms": mp_queued,
        "bound_ms": mp_bound, "bound_by": mp_by, "library_ms": mp_lib})
    del valid, target, payload, order, row, col, fits, cols, out_k, out_p
    del stacked, lib_buf, lib_idx, succ_l, dist0, skey, out_s

    lap("phase 2")

    # ---------------------------------------------------------- phase 3
    def solve(rank, cfg, mesh=mesh, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, r, st = rank_list_with_stats(succ_np, rank, mesh, cfg=cfg,
                                        seed=SEED, device=dev, **kw)
        torch.cuda.synchronize()
        return s, r, st, time.perf_counter() - t

    def check_oracle(s, r, s_ref, r_ref, what):
        if not (np.array_equal(s.cpu().numpy(), s_ref)
                and r.cpu().numpy().tobytes() == r_ref.tobytes()):
            fail(f"{what}: output differs from the sequential oracle")

    t0 = time.time()
    s_ref, r_ref = oracle.result()[2:]
    del oracle
    log(f"phase 3: waited {time.time() - t0:.1f} s for the oracle")
    lc_ops.LAUNCHES = 0
    mp_ops.LAUNCHES = 0
    s_on, r_on, st_on, wall_cold = solve(rank_np, cfg_on)
    launches = {"local_chase": lc_ops.LAUNCHES,
                "mailbox_pack": mp_ops.LAUNCHES}
    check_oracle(s_on, r_on, s_ref, r_ref, "main path (int32)")
    ints_on = {k: v for k, v in st_on.items() if isinstance(v, int)}
    log(f"phase 3: n={n_main} p={P_MAIN} kernels on: exact; attempts "
        f"{st_on['attempts']}, scales_log {st_on['scales_log']}")
    log(f"  counters {ints_on}")
    log(f"  launches {launches}; cold wall {wall_cold:.3f} s")
    if launches["local_chase"] < 1:
        fail("local_chase was not launched on the main path")
    # every PE counts each chase round; the post stage sums over PEs
    rounds = st_on["rounds"] // P_MAIN
    if launches["mailbox_pack"] < rounds:
        fail(f"mailbox_pack launched {launches['mailbox_pack']} times for "
             f"{rounds} chase rounds")
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]

    rank_f = rank_np.astype(np.float32)  # 0/1 weights: sums < 2^24, exact
    # every partial sum of 0/1 weights is an integer below 2^24, exact in
    # float32 in any order: the float32 oracle is the int32 one cast
    s_ref_f, r_ref_f = s_ref, r_ref.astype(np.float32)
    s_f, r_f, st_f, _ = solve(rank_f, cfg_on)
    check_oracle(s_f, r_f, s_ref_f, r_ref_f, "main path (float32 0/1)")
    log("phase 3: float32 0/1 weights: exact")

    s_w, r_w, st_w, wall_warm = solve(rank_np, cfg_on, stage_counters=True)
    check_oracle(s_w, r_w, s_ref, r_ref, "main path (warm rerun)")
    results["main_path"] = {
        "n": n_main, "p": P_MAIN, "cold_wall_s": wall_cold,
        "warm_wall_s": wall_warm, "stage_wall_s": dict(st_w["stage_wall_s"]),
        "counters": ints_on, "launches": launches}
    log(f"phase 3: warm wall {wall_warm:.3f} s; per stage "
        + ", ".join(f"{k} {v:.3f} s" for k, v in st_w["stage_wall_s"]))

    lap("phase 3")

    # ---------------------------------------------------------- phase 4
    cfg_off = ListRankConfig(use_pallas=False, use_pallas_pack=False)
    s_off, r_off, st_off, wall_off = solve(rank_np, cfg_off)
    ints_off = {k: v for k, v in st_off.items() if isinstance(v, int)}
    if not (torch.equal(s_off, s_on) and torch.equal(r_off, r_on)):
        fail("kernels off: outputs differ from the kernels-on solve")
    if ints_off != ints_on:
        fail(f"kernels off: counters differ: {ints_off} vs {ints_on}")
    results["main_path"]["kernels_off_wall_s"] = wall_off
    log(f"phase 4: kernels off: identical outputs and counters; wall "
        f"{wall_off:.3f} s; per stage "
        + ", ".join(f"{k} {v:.3f} s" for k, v in st_off["stage_wall_s"]))

    lap("phase 4")

    # ---------------------------------------------------------- phase 5
    succ_g, rank_g = instances.gen_list(n_grid, gamma=1.0, seed=2)
    s_ref_g, r_ref_g = rank_list_seq(succ_g, rank_g)
    grid = sim_mesh((4, 4), ("row", "col"))
    s_g, r_g, st_g = rank_list_with_stats(
        succ_g, rank_g, grid, cfg=cfg_on, seed=SEED, device=dev,
        indirection=IndirectionSpec.grid(("row", "col")))
    check_oracle(s_g, r_g, s_ref_g, r_ref_g, "two-hop grid routing")
    log(f"phase 5: n={n_grid} on a 4x4 grid, two hops, kernels on: exact; "
        f"rounds {st_g['rounds']}, attempts {st_g['attempts']}")

    lap("phase 5")

    # ------------------------------------------------------ phases 6-7
    results["tree"], tree_out = tree_phase(dev, n_tree, cfg_on, cfg_off)
    lap("phase 6")
    results["graph"], graph_out = graph_phase(dev, n_graph, cfg_on, cfg_off)
    lap("phase 7")
    for kern in kernels:
        for path in ("tree", "graph"):
            kern[f"launches_{path}"] = results[path]["launches"][kern["name"]]

    # ------------------------------------------------------ phases 8-10
    fa_entry, results["flash_attention"] = flash_attention_phase(dev)
    results["serve"] = serve_phase(dev)
    fa_entry["launches"] = results["serve"]["launches"]
    kernels.append(fa_entry)
    results["kernels_on_off"] = kernels_on_off_phase(dev)

    lap("phases 8-10")

    # ----------------------------------------------------- phases 11-13
    ssd_entry, results["ssd_scan"] = ssd_scan_phase(dev)
    results["train"] = train_phase(dev)
    ssd_entry["launches"] = results["train"]["launches"]
    kernels.append(ssd_entry)
    results["train_on_off"] = train_on_off_phase(dev)

    lap("phases 11-13")

    # --------------------------------------------------------- phase 14
    results["recovery"] = recovery_phase(
        dev, card, succ_np, rank_np, (s_on, r_on, ints_on), cfg_on, cfg_off,
        results["main_path"]["warm_wall_s"])
    for kern in kernels:
        if kern["name"] in results["recovery"]["launches"]:
            kern["launches_recovery"] = results["recovery"]["launches"][
                kern["name"]]

    lap("phase 14")

    # --------------------------------------------------------- phase 15
    results["obs"] = obs_phase(
        dev, card, succ_np, rank_np, (s_on, r_on, ints_on), cfg_on, cfg_off,
        launches, tree_out, graph_out, n_tree, n_graph,
        results["main_path"]["warm_wall_s"])
    for kern in kernels:
        kern["launches_obs"] = results["obs"]["launches"][kern["name"]]

    # --------------------------------------------------------- phase 16
    results["dist"] = dist_phase(
        dev, card, succ_np, rank_np, (s_on, r_on, ints_on), cfg_on,
        launches, st_w["stage_collectives"], wall_warm)
    for kern in kernels:
        for part in ("nccl", "gloo"):
            kern[f"launches_dist_{part}"] = results["dist"][part][
                "launches"][kern["name"]]

    # --------------------------------------------------------- phase 17
    t_phase = time.perf_counter()
    fa_entry["hymba"], ssd_entry["hymba"] = ssm_kernels_phase(dev)
    results["ssm_serve"] = {
        arch: ssm_serve_phase(dev, arch, max_seq, max_prompt)
        for arch, max_seq, max_prompt, _ in SSM_SERVE}
    for kern in kernels:
        for arch, res in results["ssm_serve"].items():
            kern[f"launches_serve_{arch}"] = res["launches"][kern["name"]]
    results["ssm_exact"] = ssm_exactness_phase(dev)
    results["ssm_phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {results['ssm_phase_s']:.1f} s")

    # --------------------------------------------------------- phase 18
    t_phase = time.perf_counter()
    fa_rows = moe_encdec_kernels_phase(dev)
    fa_entry["seamless"], fa_entry["granite"] = (fa_rows["seamless"],
                                                 fa_rows["granite"])
    results["moe_serve"] = moe_serve_phase(dev)
    results["encdec"] = encdec_phase(dev)
    for kern in kernels:
        kern[f"launches_serve_{MOE_ARCH}"] = results["moe_serve"][
            "launches"][kern["name"]]
        kern[f"launches_encdec_{ENCDEC_ARCH}"] = results["encdec"][
            "launches"][kern["name"]]
    results["moe_exact"] = moe_exactness_phase(dev)
    results["moe_phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {results['moe_phase_s']:.1f} s")

    # --------------------------------------------------------- phase 19
    t_phase = time.perf_counter()
    results["moe_ep"] = moe_ep_phase(dev)
    for kern in kernels:
        kern["launches_moe_ep_train"] = results["moe_ep"]["launches"][
            kern["name"]]
    results["moe_ep_phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {results['moe_ep_phase_s']:.1f} s")

    # --------------------------------------------------------- phase 20
    t_phase = time.perf_counter()
    results["recovery_dist"] = recovery_dist_phase(
        dev, card, granite_remat=results["moe_ep"]["remat_row"])
    for kern in kernels:
        kern["launches_recovery_dist_rank"] = results["recovery_dist"][
            "launches"][kern["name"]]
        for arch, row in results["recovery_dist"]["remat"].items():
            kern[f"launches_remat_train_{arch}"] = row["launches"][
                kern["name"]]
    results["recovery_dist_phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20: {results['recovery_dist_phase_s']:.1f} s")

    # --------------------------------------------------------- phase 21
    rd = results["recovery_dist"]
    results["dryrun"] = dryrun_phase(
        dev, card, rows={"remat": rd["remat"][MOE_ARCH],
                         "no_remat": rd["no_remat"][MOE_ARCH]},
        grad_peaks=rd["grad_peak"])
    for kern in kernels:
        kern["launches_trace_solve"] = results["dryrun"]["launches"][
            kern["name"]]

    # --------------------------------------------------------- phase 22
    results["examples"] = examples_phase(dev, card)
    fa_entry["gemma2"] = results["examples"]["attention"]
    for kern in kernels:
        parts = results["examples"]["launches"]
        for part, counts in parts.items():
            kern[f"launches_examples_{part}"] = counts[kern["name"]]
        kern["launches_examples"] = sum(counts[kern["name"]]
                                        for counts in parts.values())

    # --------------------------------------------------------- phase 23
    results["configs"] = configs_phase(dev, card, CONFIG_N, config_made)
    pool.shutdown()
    for kern in kernels:
        kern["launches_configs"] = results["configs"]["launches"][
            kern["name"]]

    # --------------------------------------------------------- phase 24
    results["d128"] = d128_phase(dev, card)
    fa_entry["d128"] = results["d128"]["attention"]
    for kern in kernels:
        kern["launches_d128"] = results["d128"]["launches"][kern["name"]]

    # --------------------------------------------------------- phase 25
    results["kimi"] = kimi_phase(dev, card)
    fa_entry["kimi"] = results["kimi"]["attention"]
    for kern in kernels:
        kern["launches_kimi"] = results["kimi"]["launches"][kern["name"]]

    results["card"] = card
    results["kernels"] = kernels
    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out_path).write_text(json.dumps(results, indent=1))
    if t_start is not None:
        log(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ------------------------------------------------------------- phases 6-7
def tree_oracle(parent: np.ndarray):
    """(depth, subtree size, preorder, postorder) of a rooted forest on
    the host, without recursion: the numpy ``oracle_tour``, the
    sequential ranking of its unit and ±1 weightings, and the closed
    forms of ``treealg/ops.py``'s module doc."""
    from repro_torch.core.listrank import rank_list_seq
    from repro_torch.core.treealg import oracle_tour
    n = parent.shape[0]
    succ = oracle_tour(n, parent)
    arc = np.arange(2 * n)
    live = succ != arc
    _, r1 = rank_list_seq(succ, live.astype(np.int64))
    _, rpm = rank_list_seq(succ, np.where(arc % 2 == 0, 1, -1) * live)
    root = parent.copy()
    while not np.array_equal(root, root[root]):
        root = root[root]
    size_of_tree = np.bincount(root, minlength=n)[root]
    c = np.flatnonzero(parent != np.arange(n))
    depth = np.zeros(n, np.int64)
    size = size_of_tree.astype(np.int64)
    pre = np.zeros(n, np.int64)
    post = np.maximum(size - 1, 0)
    arcs = 2 * (size_of_tree[c] - 1)
    depth[c] = 2 - rpm[2 * c]
    size[c] = (r1[2 * c] - r1[2 * c + 1] + 1) // 2
    pre[c] = (arcs - r1[2 * c] + depth[c]) // 2
    post[c] = (arcs + 1 - r1[2 * c + 1] - depth[c]) // 2 - 1
    return depth, size, pre, post


def check_tree_stats(what, got, want):
    """Fail unless ``got``'s four arrays equal ``want``, the oracle's
    (:func:`tree_oracle`)."""
    for name, a, b in zip(("depth", "subtree_size", "preorder", "postorder"),
                          (got.depth, got.subtree_size, got.preorder,
                           got.postorder), want):
        if not np.array_equal(a, b):
            fail(f"{what}: {name} differs from the host oracle at "
                 f"{int(np.flatnonzero(a != b)[0])}")


def run_path(phase, call, torch, dev) -> tuple:
    """Cold call with both kernels' counts reset just before, then a warm
    timed call with peak memory. Returns (cold output, warm output,
    results)."""
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    lc_ops.LAUNCHES = 0
    mp_ops.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    cold = call()
    torch.cuda.synchronize()
    wall_cold = time.perf_counter() - t
    launches = {"local_chase": lc_ops.LAUNCHES,
                "mailbox_pack": mp_ops.LAUNCHES}
    for name, count in launches.items():
        if count < 1:
            fail(f"phase {phase}: {name} was not launched")
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    warm = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    res = {"launches": launches, "cold_wall_s": wall_cold,
           "warm_wall_s": wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    return cold, warm, res


def int_counters(stats) -> dict:
    return {k: v for k, v in stats.items() if isinstance(v, int)}


def load_example(name: str):
    """``examples/{name}.py`` imported as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_ops() -> dict:
    """Every kernel's ``ops`` module by name: its ``LAUNCHES`` counts the
    wrapper's launches (the spawned ranks read theirs through it)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops, "local_chase": lc_ops,
            "mailbox_pack": mp_ops, "ssd_scan": ssd_ops}


def tree_phase(dev, n_tree: int, cfg_on, cfg_off) -> tuple:
    """Phase 6: tree statistics at ``n_tree`` nodes, kernels on and off.
    Returns (results, the kernels-on TreeStats)."""
    import torch
    from repro_torch.core import treealg
    from repro_torch.core.listrank import instances, sim_mesh

    t = time.time()
    parent = instances.gen_tree_parents(n_tree, seed=SEED, locality=False)
    want = tree_oracle(parent)
    oracle_s = time.time() - t
    mesh = sim_mesh(P_MAIN)

    def call(cfg=cfg_on):
        return treealg.tree_stats(parent, mesh, cfg=cfg, seed=SEED,
                                  device=dev)

    cold, warm, res = run_path(6, call, torch, dev)
    check_tree_stats("tree path (kernels on)", cold, want)
    st = warm.stats
    if int_counters(st) != int_counters(cold.stats):
        fail("tree path: the warm rerun's counters differ")
    res.update(n=n_tree, p=P_MAIN, oracle_s=oracle_s,
               arcs=4 * n_tree, counters=int_counters(st),
               stage_wall_s=dict(st["stage_wall_s"]))
    log(f"phase 6: tree_stats n={n_tree} p={P_MAIN} kernels on: exact "
        f"against the host oracle ({oracle_s:.1f} s); batched solve of 2 x "
        f"{2 * n_tree} arcs, attempts {st['attempts']}, rounds "
        f"{st['rounds']}; launches per call {res['launches']}")
    log(f"phase 6: cold {res['cold_wall_s']:.3f} s, warm "
        f"{res['warm_wall_s']:.3f} s; solve stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in st["stage_wall_s"])
        + f"; peak memory {res['peak_memory_bytes'] / 2 ** 30:.2f} GiB")

    off = call(cfg_off)
    for k in ("depth", "subtree_size", "preorder", "postorder", "root_of"):
        if not np.array_equal(getattr(off, k), getattr(cold, k)):
            fail(f"tree path, kernels off: {k} differs from kernels on")
    if int_counters(off.stats) != int_counters(cold.stats):
        fail(f"tree path, kernels off: counters differ: "
             f"{int_counters(off.stats)} vs {int_counters(cold.stats)}")
    log("phase 6: kernels off: identical outputs and counters")

    # re-rooting and the batched forest door, once each
    small = instances.gen_tree_parents(FOREST_NODES, seed=SEED)
    new_root = FOREST_NODES // 2 + 1
    newp = treealg.root_tree(small, new_root, mesh, cfg=cfg_on, device=dev)
    e_old = np.sort(np.stack([np.arange(FOREST_NODES), small], 1)[
        small != np.arange(FOREST_NODES)], axis=1)
    e_new = np.sort(np.stack([np.arange(FOREST_NODES), newp], 1)[
        newp != np.arange(FOREST_NODES)], axis=1)
    depth = tree_oracle(newp)[0]
    if not (newp[new_root] == new_root and np.array_equal(
            e_old[np.lexsort(e_old.T[::-1])], e_new[np.lexsort(e_new.T[::-1])])
            and (depth[np.arange(FOREST_NODES) != new_root] > 0).all()):
        fail("root_tree: not the input's edges rooted at the new root")
    parents = [instances.gen_tree_parents(FOREST_NODES, seed=s,
                                          locality=bool(s % 2))
               for s in range(FOREST_TREES)]
    for b, st_b in enumerate(treealg.solve_forest(parents, mesh, cfg=cfg_on,
                                                  device=dev)):
        check_tree_stats(f"solve_forest tree {b}", st_b,
                         tree_oracle(parents[b]))
    log(f"phase 6: root_tree (n={FOREST_NODES}, new root {new_root}) and "
        f"solve_forest ({FOREST_TREES} trees of {FOREST_NODES} nodes): exact")
    return res, cold


def check_forest(edges, n, gs, comp) -> None:
    """Fail unless ``gs.parent`` is a forest of input edges rooted at
    each component's minimum id that spans each component."""
    parent = gs.parent.astype(np.int64)
    v = np.flatnonzero(parent != np.arange(n))
    lo, hi = np.minimum(edges[:, 0], edges[:, 1]), np.maximum(edges[:, 0],
                                                                edges[:, 1])
    keys = np.unique(lo * n + hi)
    fkeys = np.minimum(v, parent[v]) * n + np.maximum(v, parent[v])
    pos = np.clip(np.searchsorted(keys, fkeys), 0, keys.size - 1)
    if v.size and not (keys[pos] == fkeys).all():
        fail("graph path: a forest parent link is not an input edge")
    if not np.array_equal(np.flatnonzero(parent == np.arange(n)),
                          np.unique(comp)):
        fail("graph path: the roots are not the components' minimum ids")
    root = parent.copy()
    for _ in range(max(int(n).bit_length(), 1) + 1):
        root = root[root]
    if not np.array_equal(root, comp):
        fail("graph path: the forest does not span each component "
             "(or has a cycle)")


def graph_phase(dev, n_graph: int, cfg_on, cfg_off) -> tuple:
    """Phase 7: graph statistics at ``n_graph`` nodes, 4 x as many edges
    in 4 components, kernels on and off. Returns (results, the kernels-on
    GraphStats)."""
    import scipy.sparse
    import scipy.sparse.csgraph
    import torch
    from repro_torch.core import graphalg
    from repro_torch.core.listrank import instances, sim_mesh

    n = n_graph
    t = time.time()
    edges = instances.gen_graph_edges(n, 4 * n, seed=SEED, locality=False,
                                      num_components=4)
    ncomp, lab = scipy.sparse.csgraph.connected_components(
        scipy.sparse.coo_matrix((np.ones(edges.shape[0], np.int8),
                                 (edges[:, 0], edges[:, 1])), shape=(n, n)),
        directed=False)
    mins = np.full(ncomp, n, np.int64)
    np.minimum.at(mins, lab, np.arange(n))
    comp = mins[lab]
    oracle_s = time.time() - t
    mesh = sim_mesh(P_MAIN)

    def call(cfg=cfg_on):
        return graphalg.graph_stats(edges, n, mesh, cfg=cfg, seed=SEED,
                                    device=dev)

    cold, warm, res = run_path(7, call, torch, dev)
    if not np.array_equal(cold.components, comp):
        fail("graph path: components differ from scipy's")
    check_forest(edges, n, cold, comp)
    check_tree_stats("graph path (kernels on)", cold,
                     tree_oracle(cold.parent))
    st = warm.stats
    if int_counters(st) != int_counters(cold.stats):
        fail("graph path: the warm rerun's counters differ")
    res.update(n=n, edges=int(edges.shape[0]), p=P_MAIN, components=ncomp,
               oracle_s=oracle_s, counters=int_counters(st),
               stage_wall_s=dict(st["stage_wall_s"]))
    log(f"phase 7: graph_stats n={n} E={edges.shape[0]} p={P_MAIN} kernels "
        f"on: {ncomp} components equal to scipy's, the forest valid, its "
        f"statistics exact against the tree oracle; hooking rounds "
        f"{st['cc_rounds']}, forest edges {st['forest_edges']}, attempts "
        f"{st['attempts']}, solver rounds {st['rounds']}; launches per call "
        f"{res['launches']}")
    log(f"phase 7: cold {res['cold_wall_s']:.3f} s, warm "
        f"{res['warm_wall_s']:.3f} s; per phase "
        + ", ".join(f"{k} {v:.3f} s" for k, v in st["stage_wall_s"])
        + f"; peak memory {res['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    fp = graphalg.frontdoor.footprint_of(st["stage_collectives"])
    jumps = fp["cc:jump"] if isinstance(fp["cc:jump"], tuple) \
        else (fp["cc:jump"],)
    res["shortcut_iterations"] = sum(
        label == "cc:jump" for label, _ in st["stage_collectives"])
    res["collectives"] = {k: v for k, v in fp.items()
                          if not k.startswith("solve")}
    log(f"phase 7: {st['cc_rounds']} hooking rounds, "
        f"{res['shortcut_iterations']} shortcut iterations; collectives per "
        f"hooking round {fp['cc:hook']}, per shortcut iteration "
        f"{list(jumps)}, tour {fp['tour']}, finalize {fp['finalize']}")

    off = call(cfg_off)
    for k in ("components", "parent", "depth", "subtree_size", "preorder",
              "postorder"):
        if not np.array_equal(getattr(off, k), getattr(cold, k)):
            fail(f"graph path, kernels off: {k} differs from kernels on")
    if int_counters(off.stats) != int_counters(cold.stats):
        fail(f"graph path, kernels off: counters differ: "
             f"{int_counters(off.stats)} vs {int_counters(cold.stats)}")
    log("phase 7: kernels off: identical outputs and counters")
    return res, cold


# ---------------------------------------------------------------- phase 8
SERVE_ARCH = "tinyllama-1.1b"
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_MAX_NEW, SERVE_REQUESTS = 8, 2048, 32, 16


def attention_bound(b, hq, hkv, lq, d, offsets, lk, elem_bytes, window=None,
                    ops_per_s=None):
    """(bound ms, what bounds it) of causal attention, over the last
    ``window`` keys if given: 4*D operations per unmasked (q, k) pair at
    ``ops_per_s`` (the bf16 tensor peak by default); bytes of q, o and
    the K/V rows some query keeps, each moved once."""
    from repro_torch.devtime import BF16_OPS_PER_S, bound_ms
    pos = np.asarray(offsets, np.int64)[:, None] + np.arange(lq)
    lo = np.zeros_like(pos) if window is None else pos - window + 1
    lo = np.clip(lo, 0, lk)
    pairs = int((np.clip(pos + 1, 0, lk) - lo).clip(0).sum())
    kv_rows = int((np.clip(pos.max(axis=1) + 1, 0, lk)
                   - lo.min(axis=1)).clip(0).sum())
    nbytes = elem_bytes * (2 * b * hq * lq * d + 2 * hkv * kv_rows * d)
    return bound_ms(nbytes, 4 * hq * d * pairs, ops_per_s or BF16_OPS_PER_S)


def sdpa_backend(fn, torch) -> tuple[list[str], dict]:
    """The device kernels one call of ``fn`` ran (one torch.profiler
    window) and the enabled ``torch.backends.cuda.*_sdp`` flags: which
    SDPA backend the yardstick is."""
    flags = {k: getattr(torch.backends.cuda, f"{k}_sdp_enabled")()
             for k in ("flash", "mem_efficient", "math", "cudnn")
             if hasattr(torch.backends.cuda, f"{k}_sdp_enabled")}
    from repro_torch import devtime
    try:
        _, events, _ = devtime.checked_window(
            lambda: devtime.window(fn, torch),
            lambda ev: None if ev else "no device events", log=log)
        names = sorted({e["name"][:100] for e in events or ()})
    except Exception as exc:  # the profiler is information here, no gate
        names = [f"(no profile: {type(exc).__name__}: {exc})"]
    return names, flags


def flash_attention_phase(dev):
    """Phase 8: the kernel against its plain version; times at the serving
    path's shapes. Returns (the kernels-line entry, results)."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import ATTN_CASES, ATTN_TOL, attn_inputs
    from repro_torch import devtime
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    errs = []
    for dt in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dt]
        for i, (b, hq, hkv, lq, lk, d, kw) in enumerate(ATTN_CASES):
            q, k, v = (t.to(dev) for t in attn_inputs(b, hq, hkv, lq, lk, d,
                                                       seed=i, dtype=dt))
            out = fa_ops.flash_attention(q, k, v, **kw).float()
            want = fa_ref.attention_ref(q, k, v, **kw).float()
            torch.cuda.synchronize()
            if not torch.allclose(out, want, **tol):
                fail(f"flash_attention case {i} {dt} differs from its plain "
                     f"version by {max_abs_err(out, want, torch)}")
            errs.append(max_abs_err(out, want, torch))
        log(f"phase 8: flash_attention {dt}: {len(ATTN_CASES)} cases within "
            f"{tol}; max |err| {max(errs):.3g}")

    # the serving path's shapes: tinyllama's heads over a 2048-key cache
    hq, hkv, d, lk = 32, 4, 64, SERVE_MAX_SEQ
    g = torch.Generator(device=dev).manual_seed(11)
    rows = {}
    shapes = {"prefill": (1, 1024, [0]),
              "decode": (SERVE_SLOTS, 1, np.random.default_rng(3).integers(
                  0, lk, SERVE_SLOTS).tolist())}
    for name, (b, lq, offs) in shapes.items():
        q = torch.randn((b, hq, lq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, hkv, lk, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, hkv, lk, d), generator=g, device=dev).bfloat16()
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        q_offset = offs[0] if name == "prefill" else off
        mask = (torch.arange(lk, device=dev)[None, :]
                <= (off[:, None] + lq - 1))[:, None, None, :]
        if name == "prefill":  # upper-left causal over Lq x Lk == offset 0

            def library_call():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
        else:

            def library_call():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)

        out = fa_ops.flash_attention(q, k, v, q_offset=q_offset).float()
        want = fa_ref.attention_ref(q, k, v, q_offset=q_offset).float()
        lib = library_call().float()
        torch.cuda.synchronize()
        if not torch.allclose(out, want, **ATTN_TOL[torch.bfloat16]):
            fail(f"flash_attention {name} differs from its plain version by "
                 f"{max_abs_err(out, want, torch)}")
        if not torch.allclose(lib, want, **ATTN_TOL[torch.bfloat16]):
            fail(f"the SDPA yardstick computes another function ({name})")
        ms = time_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                    q_offset=q_offset), torch)
        plain = time_ms(lambda: fa_ref.attention_ref(q, k, v,
                                                     q_offset=q_offset), torch)
        lib_ms = time_ms(library_call, torch)
        dev_ms = device_ms(lambda: fa_ops.flash_attention(
            q, k, v, q_offset=q_offset), torch,
            devtime.EXPECT[f"flash_attention_{name}_bf16"])
        queued = devtime.queued_ms(lambda: fa_ops.flash_attention(
            q, k, v, q_offset=q_offset), torch)
        # SDPA's kernels are cuDNN's or another backend's: no names to
        # count, so its device time is the queued reading only
        lib_dev_ms = devtime.queued_ms(library_call, torch)
        sdpa_kernels, sdpa_flags = sdpa_backend(library_call, torch)
        bnd, by = attention_bound(b, hq, hkv, lq, d, offs, lk, 2)
        rows[name] = {"b": b, "lq": lq, "lk": lk, "offsets": offs,
                      "max_abs_err": max_abs_err(out, want, torch), "ms": ms,
                      "plain_ms": plain, "library_ms": lib_ms,
                      "bound_ms": bnd, "bound_by": by,
                      "device_ms": dev_ms, "queued_ms": queued,
                      "library_device_ms": lib_dev_ms,
                      "sdpa_kernels": sdpa_kernels, "sdpa_flags": sdpa_flags}
        if name == "decode":
            rows[name]["splits"] = fa_ops.decode_splits(
                b, hkv, hq // hkv, lk, torch.cuda.get_device_properties(
                    dev).multi_processor_count)
        log(f"phase 8: SDPA ({name}) ran {sdpa_kernels}; enabled backends "
            f"{sdpa_flags}")
        log(f"phase 8: flash_attention {name} bf16 B={b} Hq={hq} Hkv={hkv} "
            f"D={d} Lq={lq} Lk={lk}: max |err| {rows[name]['max_abs_err']:.3g};"
            f" kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib_ms:.4f} ms,"
            f" bound {bnd:.4f} ms by {by}"
            + (f"; split-K over {rows[name]['splits']} splits"
               if name == "decode" else "; tensor cores (mma.sync)")
            + f"; device time kernel {fmt_ms(dev_ms)} (torch.profiler, "
              f"launches counted), queued {fmt_ms(queued)}; SDPA queued "
              f"{fmt_ms(lib_dev_ms)}")
    pre, dec = rows["prefill"], rows["decode"]
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:29",
        "launches": 0,
        "max_abs_err": max(errs + [pre["max_abs_err"], dec["max_abs_err"]]),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"],
        "device_ms": pre["device_ms"], "queued_ms": pre["queued_ms"],
        "library_device_ms": pre["library_device_ms"],
        "ms_decode": dec["ms"], "plain_ms_decode": dec["plain_ms"],
        "bound_ms_decode": dec["bound_ms"], "bound_by_decode": dec["bound_by"],
        "library_ms_decode": dec["library_ms"],
        "device_ms_decode": dec["device_ms"],
        "queued_ms_decode": dec["queued_ms"],
        "library_device_ms_decode": dec["library_device_ms"]}
    return entry, {"max_abs_err_cases": max(errs), **rows}


# ---------------------------------------------------------------- phase 9
def traffic_requests(vocab_size: int, max_prompt: int,
                     n: int = SERVE_REQUESTS) -> list:
    """``n`` requests with prompts of 32..``max_prompt`` tokens from
    ``default_rng(0)`` (their lengths first, then each prompt)."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    lengths = rng.integers(32, max_prompt + 1, n)
    return [Request(uid=uid, prompt=rng.integers(
        2, vocab_size, k).astype(np.int32)) for uid, k in enumerate(lengths)]


def engine_timers(eng, torch) -> tuple[dict, list]:
    """Wrap ``eng``'s prefill and decode calls in timers between syncs:
    (ms per prefill bucket {bucket: [ms]}, ms per decode tick [ms]), filled
    as the engine runs. ``del eng._prefill, eng._decode`` afterwards: the
    timers hold the engine's bound methods."""
    prefill_ms: dict = {}
    decode_ms: list = []

    def timed(fn, record):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            record(args, (time.perf_counter() - t) * 1e3)
            return out
        return call

    eng._prefill = timed(eng._prefill, lambda a, ms: prefill_ms.setdefault(
        int(a[1].shape[1]), []).append(ms))
    eng._decode = timed(eng._decode, lambda a, ms: decode_ms.append(ms))
    return prefill_ms, decode_ms


def serve_traffic(dev, phase: int, cfg, max_seq: int, max_prompt: int) -> dict:
    """Serve ``SERVE_REQUESTS`` requests (prompts of 32..``max_prompt``
    tokens from ``default_rng(0)``, ``SERVE_MAX_NEW`` tokens each) over
    ``SERVE_SLOTS`` slots of ``max_seq`` with ``cfg`` (random weights from
    seed ``SEED``) through the engine; every request answered with tokens
    in the vocabulary. Each kernel's launches are counted from 0 just
    before the run; prefill and decode calls are timed between syncs."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    eng = ServingEngine(params, cfg, ServeConfig(
        slots=SERVE_SLOTS, max_seq=max_seq,
        max_new_tokens=SERVE_MAX_NEW), device=dev)
    requests = traffic_requests(cfg.vocab_size, max_prompt)
    lengths = np.array([len(r.prompt) for r in requests])
    for req in requests:
        eng.submit(req)

    prefill_ms, decode_ms = engine_timers(eng, torch)
    torch.cuda.reset_peak_memory_stats(dev)
    mods = {"local_chase": lc_ops, "mailbox_pack": mp_ops,
            "flash_attention": fa_ops, "ssd_scan": ssd_ops}
    for mod in mods.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}

    n_prefill = sum(len(v) for v in prefill_ms.values())
    ticks = len(decode_ms)
    tokens = sum(len(v) for v in out.values())
    if sorted(out) != list(range(SERVE_REQUESTS)) or n_prefill != SERVE_REQUESTS:
        fail(f"serving {cfg.name}: {len(out)} requests answered, {n_prefill} "
             "prefills")
    for uid, toks in out.items():
        if not 1 <= len(toks) <= SERVE_MAX_NEW or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"serving {cfg.name}: request {uid} returned {toks}")
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "requests": SERVE_REQUESTS,
           "max_seq": max_seq, "prompt_lengths": lengths.tolist(),
           "prefills": n_prefill, "decode_ticks": ticks,
           "generated_tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "prefill_ms_median": {b: statistics.median(v)
                                 for b, v in sorted(prefill_ms.items())},
           "prefill_ms": {b: v for b, v in sorted(prefill_ms.items())},
           "decode_ms_median": statistics.median(decode_ms),
           "decode_ms": decode_ms, "launches": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"phase {phase}: served {SERVE_REQUESTS} requests with {cfg.name} "
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{str(cfg.dtype).removeprefix('torch.')}, kernels on):"
        f" {n_prefill} prefills, {ticks} decode ticks, {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tokens/s; launches {launches}")
    log("  prefill ms per bucket (median of n): " + ", ".join(
        f"{b}: {statistics.median(v):.2f} (n={len(v)})"
        for b, v in sorted(prefill_ms.items())))
    log(f"  decode ms per tick: median {res['decode_ms_median']:.3f}, min "
        f"{min(decode_ms):.3f}, max {max(decode_ms):.3f}; peak memory "
        f"{res['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    # the timers hold the engine's bound methods: break the cycle, or the
    # weights and the cache outlive the phase until a garbage collection
    del eng._prefill, eng._decode
    del params, eng
    torch.cuda.empty_cache()
    return res


def serve_phase(dev) -> dict:
    """Phase 9: tinyllama-1.1b at full width served through the engine,
    ``flash_attention`` on every attention call."""
    from repro_torch import configs

    cfg = configs.get_config(SERVE_ARCH).with_(use_kernels=True)
    res = serve_traffic(dev, 9, cfg, SERVE_MAX_SEQ, 1024)
    need = cfg.num_layers * (res["prefills"] + res["decode_ticks"])
    res["launches"] = res["launches"]["flash_attention"]
    if res["launches"] < need:
        fail(f"serving: flash_attention launched {res['launches']} times, "
             f"the path has {need} attention calls")
    log(f"phase 9: flash_attention launches {res['launches']} >= {need}")
    return res


# ---------------------------------------------------------------- phase 10
def teacher_forced_logits(params, cfg, prompt, steps: int, max_seq: int, dev,
                          teacher=None, prefix_embeds=None):
    """(logits (1, 1 + steps, V), the tokens fed): ``prompt`` (1, L),
    behind ``prefix_embeds`` (1, P, ``cfg.prefix_embed_dim``) if given,
    prefilled into a cache of ``max_seq``, then ``steps`` decode steps from
    position P + L fed ``teacher``'s tokens, or the greedy ones when
    None."""
    from repro_torch.models import model as M
    import torch
    batch = {"tokens": prompt}
    start = prompt.shape[1]
    if prefix_embeds is not None:
        batch["prefix_embeds"] = prefix_embeds
        start += prefix_embeds.shape[1]
    cache = M.init_cache(cfg, 1, max_seq, dev)
    lg, cache = M.prefill(params, batch, cfg, cache)
    out, fed = [lg], []
    for i in range(steps):
        tok = teacher[i] if teacher is not None else \
            torch.argmax(lg[0, 0, :cfg.vocab_size]).view(1, 1).int()
        fed.append(tok)
        lg, cache = M.decode_step(params, tok, start + i, cfg, cache)
        out.append(lg)
    return torch.cat(out, dim=1), fed


def kernels_on_off_phase(dev) -> dict:
    """Phase 10: full-width logits with the kernel on and off, prefill plus
    16 decode steps fed the kernels-off greedy tokens."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 10: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    vocab = configs.get_config(SERVE_ARCH).vocab_size
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        2, vocab, (1, 1000)).astype(np.int32)).to(dev)
    steps = 16

    res = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = configs.get_config(SERVE_ARCH).with_(dtype=dt)
        params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
        off, fed = teacher_forced_logits(params, cfg, prompt, steps,
                                         SERVE_MAX_SEQ, dev)
        fa_ops.LAUNCHES = 0
        on, _ = teacher_forced_logits(params, cfg.with_(use_kernels=True),
                                      prompt, steps, SERVE_MAX_SEQ, dev,
                                      teacher=fed)
        launches = fa_ops.LAUNCHES
        torch.cuda.synchronize()
        diff = max_abs_err(on, off, torch)
        name = str(dt).removeprefix("torch.")
        res[name] = {"max_abs_diff": diff, "launches": launches}
        log(f"phase 10: {cfg.name} {name}, prompt {prompt.shape[1]} + {steps} "
            f"teacher-forced steps: max |logits on - off| {diff:.3g}; "
            f"flash_attention launches {launches}")
        if launches < cfg.num_layers * (1 + steps):
            fail(f"kernels on ({name}): {launches} launches")
        if dt == torch.float32 and not torch.allclose(on, off, atol=2e-3,
                                                      rtol=1e-3):
            fail(f"kernels on vs off (float32): logits differ by {diff}")
        del params, on, off
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 11
TRAIN_ARCH = "mamba2-130m"
#: mamba2-130m's training shape: (Bt, L, H, G, N, P, chunk)
SSD_MAIN = (8, 1024, 24, 1, 128, 64, 256)
#: phase 12's batch (8 x 1024 before the script's time limit), steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 2


def ssd_bound(bt, l, h, g, n, p, chunk, elem_bytes, skip=True,
              ops_per_s=None):
    """(bound ms, what bounds it) of the chunked scan. Operations: per
    (batch, head) and chunk of r rows, C B^T and W (dt x) over the causal
    triangle only, 2 (N + P) per pair s <= t and r (r + 1) / 2 pairs (the
    masked half is not work, as attention_bound counts only unmasked
    pairs), then C S and the state update (2 r N P each), at the bf16
    tensor peak (or ``ops_per_s``). Bytes: x, y, B, C in ``elem_bytes``,
    dt, A and D in float32, each moved once."""
    q = min(chunk, l)
    rows = [q] * (l // q) + ([l % q] if l % q else [])
    ops = bt * h * sum(r * (r + 1) * (n + p) + 4 * r * n * p for r in rows)
    nbytes = (elem_bytes * (2 * bt * l * h * p + 2 * bt * l * g * n)
              + 4 * (bt * l * h + h * (2 if skip else 1)))
    from repro_torch.devtime import BF16_OPS_PER_S, bound_ms
    return bound_ms(nbytes, ops, ops_per_s or BF16_OPS_PER_S)


def ssd_scan_phase(dev):
    """Phase 11: the kernel against its plain version, forward and gradient,
    and its times. Returns (the kernels-line entry, results)."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import SSD_CASES, SSD_TOL, ssd_inputs
    from repro_torch import devtime
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    errs = []
    for i, case in enumerate(SSD_CASES):
        bt, l, h, g, n, p, chunk = case
        args = [t.to(dev) for t in ssd_inputs(bt, l, h, g, n, p,
                                              seed=sum(case))]
        for skip in (True, False):
            a = args if skip else args[:5] + [None]
            out = ssd_ops.ssd_scan(*a, chunk)
            want = ssd_ref.ssd_ref(*a)
            torch.cuda.synchronize()
            if not torch.allclose(out, want, **SSD_TOL):
                fail(f"ssd_scan case {i} (D={skip}) differs from its plain "
                     f"version by {max_abs_err(out, want, torch)}")
            errs.append(max_abs_err(out, want, torch))
    log(f"phase 11: ssd_scan float32: {len(SSD_CASES)} cases x (D, no D) "
        f"within {SSD_TOL}; max |err| {max(errs):.3g}")

    bt, l, h, g, n, p, chunk = SSD_MAIN
    res = {"shape": dict(zip("bt l h g n p chunk".split(), SSD_MAIN))}
    for dt, tol in ((torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
                    (torch.float32, SSD_TOL)):
        name = str(dt).removeprefix("torch.")
        args = [t.to(dev) for t in ssd_inputs(bt, l, h, g, n, p, seed=1,
                                              dtype=dt)]
        out = ssd_ops.ssd_scan(*args, chunk)
        want = ssd_ref.ssd_ref(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out.float(), want.float(), torch)
        if not torch.allclose(out.float(), want.float(), **tol):
            fail(f"ssd_scan {name} at the mamba2-130m shape differs from its "
                 f"plain version by {err}")
        ms = time_ms(lambda: ssd_ops.ssd_scan(*args, chunk), torch)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        dev_ms = device_ms(lambda: ssd_ops.ssd_scan(*args, chunk), torch,
                           devtime.EXPECT[f"ssd_scan_{kind}"])
        queued = devtime.queued_ms(lambda: ssd_ops.ssd_scan(*args, chunk),
                                   torch)
        chunked = time_ms(lambda: ssd_ref.ssd_chunked_ref(*args, chunk=chunk),
                          torch, reps=10)
        seq = time_ms(lambda: ssd_ref.ssd_ref(*args), torch, reps=3)
        bnd, by = ssd_bound(*SSD_MAIN, 2 if dt == torch.bfloat16 else 4)
        res[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "queued_ms": queued,
                     "plain_ms": chunked, "plain_sequential_ms": seq,
                     "bound_ms": bnd, "bound_by": by}
        log(f"phase 11: ssd_scan {name} Bt={bt} L={l} H={h} P={p} G={g} N={n} "
            f"Q={chunk}: max |err| {err:.3g} (tolerance {tol}); kernel "
            f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}, queued "
            f"{fmt_ms(queued)}), ssd_chunked_ref {chunked:.4f} ms, ssd_ref {seq:.2f} ms, bound {bnd:.4f} ms by "
            f"{by}")
        del out, want

    # gradient at the full shape: the Function against autograd through
    # ssd_ref (float32; both backwards are autograd through ssd_ref)
    args = [t.to(dev) for t in ssd_inputs(bt, l, h, g, n, p, seed=2)]
    w = torch.randn(args[0].shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(3))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in args]
        return torch.autograd.grad((fn(*leaves) * w).sum(), leaves)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = grads(lambda *a: ssd_ops.ssd_scan(*a, chunk))
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    want = grads(ssd_ref.ssd_ref)
    gerr = 0.0
    for name, a, b in zip("x dt A B C D".split(), got, want):
        if not (torch.isfinite(a).all() and torch.allclose(a, b, **SSD_TOL)):
            fail(f"ssd_scan gradient in {name} differs from ssd_ref's by "
                 f"{max_abs_err(a, b, torch)}")
        gerr = max(gerr, max_abs_err(a, b, torch))
    res["grad_max_abs_err"], res["grad_s"] = gerr, grad_s
    log(f"phase 11: ssd_scan gradient of x, dt, A, B, C, D at the full shape "
        f"(float32) within {SSD_TOL} of autograd through ssd_ref: max |err| "
        f"{gerr:.3g}; forward + backward {grad_s:.2f} s (host clock)")
    del got, want, args, w
    torch.cuda.empty_cache()
    bf = res["bfloat16"]
    entry = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:35",
        "launches": 0,
        "max_abs_err": max(errs + [bf["max_abs_err"],
                                   res["float32"]["max_abs_err"]]),
        "ms": bf["ms"], "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": None, "device_ms": bf["device_ms"],
        "ms_float32": res["float32"]["ms"],
        "plain_ms_float32": res["float32"]["plain_ms"],
        "bound_ms_float32": res["float32"]["bound_ms"],
        "plain_sequential_ms": bf["plain_sequential_ms"]}
    return entry, res


# --------------------------------------------------------------- phase 12
def train_phase(dev) -> dict:
    """Phase 12: mamba2-130m at full width trained through launch.train."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import train as train_launch

    cfg = configs.get_config(TRAIN_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ssd_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    history = train_launch.main([
        "--arch", TRAIN_ARCH, "--use-kernels", "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
        "--log-every", "1", "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ssd_ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)

    losses = [h["loss"] for h in history]
    gnorms = [h["grad_norm"] for h in history]
    if len(history) != TRAIN_STEPS or not all(
            np.isfinite(losses + gnorms)):
        fail(f"training: losses {losses}, gradient norms {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"training: the loss did not fall: {losses}")
    # each layer's forward and its remat recompute (cfg.remat)
    if launches != 2 * cfg.num_layers * TRAIN_STEPS:
        fail(f"training: ssd_scan launched {launches} times for "
             f"{TRAIN_STEPS} remat'd steps of {cfg.num_layers} layers")
    ms = [h["ms"] for h in history]
    warm = ms[1:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": str(cfg.dtype), "batch":
           TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "losses": losses, "grad_norms": gnorms, "step_ms": ms,
           "batch_ms": [h["batch_ms"] for h in history],
           "first_step_ms": ms[0], "warm_step_ms_mean": statistics.mean(warm),
           "tokens_per_s": tokens * len(warm) / (sum(warm) / 1e3),
           "wall_s": wall, "launches": launches, "peak_memory_bytes": peak}
    log(f"phase 12: trained {cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {str(cfg.dtype).removeprefix('torch.')}, kernels "
        f"on) {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; gradient norms "
        f"{', '.join(f'{x:.3f}' for x in gnorms)}")
    log(f"  step ms: first {ms[0]:.1f}, then "
        f"{', '.join(f'{x:.1f}' for x in warm)} (host clock, data included: "
        f"{', '.join(f'{h['batch_ms']:.1f}' for h in history)} ms); "
        f"{res['tokens_per_s']:.1f} tokens/s after the first; ssd_scan "
        f"launches {launches}; peak memory {peak / 2 ** 30:.2f} GiB")
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------- phase 13
def train_on_off_phase(dev) -> dict:
    """Phase 13: kernels on against off on the training path."""
    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    from repro_torch.train import steps
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import SSD_TOL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tcfg = steps.TrainConfig()
    res = {}

    # mamba2-130m, float32: the loss of one batch, ssd_scan vs chunked
    cfg = configs.get_config(TRAIN_ARCH).with_(dtype=torch.float32)
    batch = pipeline.device_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH), 0, dev)
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)

    def loss_of(c):
        with torch.no_grad():
            logits, _ = M.forward(params, batch, c)
        return logits, float(steps.next_token_loss(
            logits, batch["labels"], c, tcfg.z_loss))

    # every layer's kernel call of the kernels-on forward is recorded, inputs
    # and output, and held against ssd_ref below: the model's own dt and A
    # drive a chunk's summed log-decay far below -88, where exp underflows
    # in float32, which phase 11's drawn inputs never reach
    calls, launch = [], ssd_ops._launch

    def recording_launch(*a):
        y = launch(*a)
        calls.append((a, y))
        return y

    ssd_ops.LAUNCHES = 0
    ssd_ops._launch = recording_launch
    try:
        logits_on, on = loss_of(cfg.with_(use_kernels=True))
    finally:
        ssd_ops._launch = launch
    launches = ssd_ops.LAUNCHES
    logits_off, off = loss_of(cfg)
    rel = abs(on - off) / abs(off)
    diff = max_abs_err(logits_on, logits_off, torch)
    res["mamba_float32"] = {"loss_on": on, "loss_off": off, "rel_diff": rel,
                            "logits_max_abs_diff": diff, "launches": launches}
    log(f"phase 13: {cfg.name} float32 loss of one {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} batch: ssd_scan {on:.7f}, ssd_chunked_ref {off:.7f}, "
        f"relative difference {rel:.3g} (max |logits on - off| {diff:.3g}, "
        f"information); launches {launches}")
    del logits_on, logits_off
    if not (np.isfinite(on) and rel <= 1e-4):
        fail(f"kernels on vs off (mamba, float32): losses {on} and {off}")
    if launches != cfg.num_layers or len(calls) != cfg.num_layers:
        fail(f"kernels on (mamba): {launches} ssd_scan launches")
    layer_errs, decay_min = [], 0.0
    for i, ((x, dt, a, bh, ch, d_skip, chunk), y) in enumerate(calls):
        want = ssd_ref.ssd_ref(x, dt, a, bh, ch, d_skip)
        err = max_abs_err(y, want, torch)
        if not (torch.isfinite(y).all() and torch.allclose(y, want,
                                                           **SSD_TOL)):
            fail(f"ssd_scan on layer {i}'s own inputs differs from ssd_ref "
                 f"by {err}")
        layer_errs.append(err)
        lc = (dt * a).cumsum(1)[:, chunk - 1::chunk]
        decay_min = min(decay_min, float(torch.diff(
            lc, dim=1, prepend=torch.zeros_like(lc[:, :1])).min()))
        del want
    res["mamba_float32"].update(layer_max_abs_err=max(layer_errs),
                                chunk_log_decay_min=decay_min)
    log(f"phase 13: ssd_scan on each of the {len(calls)} layers' own inputs "
        f"(float32) within {SSD_TOL} of ssd_ref: max |err| "
        f"{max(layer_errs):.3g}; most negative summed log-decay of a chunk "
        f"{decay_min:.1f}")
    del params, calls
    torch.cuda.empty_cache()

    # tinyllama-1.1b at full width, 2 layers: flash_attention in training
    base = configs.get_config(SERVE_ARCH).with_(num_layers=2)
    batch = pipeline.device_batch(pipeline.DataConfig(
        vocab_size=base.vocab_size, seq_len=TRAIN_SEQ, global_batch=2), 0,
        dev)
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).removeprefix("torch.")
        cfg = base.with_(dtype=dt)
        params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
        fa_ops.LAUNCHES = 0
        (loss, _), g_on = steps.value_and_grad(
            params, batch, cfg.with_(use_kernels=True), tcfg)
        launches = fa_ops.LAUNCHES
        flat_on = leaves(g_on)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in flat_on)
        # each layer's forward and its remat recompute (cfg.remat)
        if not finite or launches != 2 * cfg.num_layers:
            fail(f"tinyllama {name} train step with flash_attention: loss "
                 f"{float(loss)}, finite {finite}, launches {launches}")
        row = {"loss": float(loss), "launches": launches}
        if dt == torch.float32:
            (loss_off, _), g_off = steps.value_and_grad(params, batch, cfg,
                                                        tcfg)
            diff = max(max_abs_err(a, b, torch)
                       for a, b in zip(flat_on, leaves(g_off)))
            ok = all(torch.allclose(a, b, atol=2e-3, rtol=1e-3)
                     for a, b in zip(flat_on, leaves(g_off)))
            row.update(loss_off=float(loss_off), grad_max_abs_diff=diff)
            if not ok:
                fail(f"kernels on vs off (tinyllama, float32): gradients "
                     f"differ by {diff}")
        res[f"tinyllama_{name}"] = row
        log(f"phase 13: {cfg.name} ({cfg.num_layers} layers, full width) "
            f"{name} train step with flash_attention: loss {float(loss):.5f},"
            f" gradients finite, launches {launches}"
            + (f"; against the plain path: loss {row['loss_off']:.5f}, max "
               f"|grad on - off| {row['grad_max_abs_diff']:.3g}"
               if dt == torch.float32 else ""))
        del params, g_on
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------- phase 14
#: the free space phase 14 needs for its checkpoints (three boundaries of
#: up to ~0.6 GB kept, and one copy)
RECOVERY_FREE_BYTES = 4 << 30


def executed(stage_log, kind: str) -> int:
    """Executions of stages of ``kind`` in a stage log: committed, or run
    and then refused (an overflow or a corrupted state; a PE loss fires
    before its stage runs)."""
    return sum(1 for e in stage_log
               if e.split("@")[0].split("!")[0] == kind
               and not e.endswith("!InjectedFault"))


def recovery_phase(dev, card: str, succ_np, rank_np, plain, cfg_on, cfg_off,
                   plain_warm_s: float) -> dict:
    """Phase 14: the solve under a SolveSupervisor, six fault cases."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.listrank import (FaultSpec, rank_list_with_stats,
                                           resume, sim_mesh)
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.runtime.fault_tolerance import (Preempted,
                                                     SolveSupervisor,
                                                     SolveSupervisorConfig)

    s_plain, r_plain, ints_plain = plain
    mesh = sim_mesh(P_MAIN)
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_recovery_"))
    res: dict = {"cases": {}}
    try:
        free = shutil.disk_usage(root).free
        log(f"phase 14: checkpoints under a fresh temporary directory, "
            f"{free / 2 ** 30:.1f} GiB free")
        if free < RECOVERY_FREE_BYTES:
            fail(f"phase 14: {free} bytes free under {root}, "
                 f"{RECOVERY_FREE_BYTES} needed")

        def supervised(case, directory, cfg=cfg_on, inject=None,
                       preempted=False):
            """One supervised solve on ``directory``, the kernels' counts
            reset just before and read just after; checks its outputs
            (and, unless faults changed the capacities, its counters)
            against phase 3's and the launches against the stages run."""
            sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=str(
                root / directory)))
            lc_ops.LAUNCHES = 0
            mp_ops.LAUNCHES = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                s, r, st = rank_list_with_stats(
                    succ_np, rank_np, mesh, cfg=cfg, seed=SEED, device=dev,
                    supervisor=sup, inject=inject)
            except Preempted:
                if not preempted:
                    raise
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches = {"local_chase": lc_ops.LAUNCHES,
                            "mailbox_pack": mp_ops.LAUNCHES}
                res["cases"][case] = {"wall_s": wall, "launches": launches,
                                      "preempted_at": sup.ckpt.latest_step()}
                if launches["local_chase"] != 1 or \
                        launches["mailbox_pack"] < 2:
                    fail(f"phase 14 ({case}): launches {launches} before "
                         f"the preemption after prep and two levels")
                return sup, None
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if preempted:
                fail(f"phase 14 ({case}): the solve was not preempted")
            launches = {"local_chase": lc_ops.LAUNCHES,
                        "mailbox_pack": mp_ops.LAUNCHES}
            log_ = st["stage_log"]
            if not (torch.equal(s, s_plain) and torch.equal(r, r_plain)):
                fail(f"phase 14 ({case}): outputs differ from phase 3's")
            if st["attempts"] == 1 and int_counters(st) != ints_plain:
                fail(f"phase 14 ({case}): counters {int_counters(st)} differ "
                     f"from phase 3's {ints_plain}")
            preps = executed(log_, "prep")
            others = sum(executed(log_, k) for k in
                         ("descend", "base", "ascend", "post"))
            on = cfg.use_pallas
            if on and (launches["local_chase"] != preps
                       or launches["mailbox_pack"] < others):
                fail(f"phase 14 ({case}): launches {launches} for {preps} "
                     f"prep and {others} other stage executions ({log_})")
            if not on and any(launches.values()):
                fail(f"phase 14 ({case}): kernels off, yet {launches}")
            rec = st["recovery"]
            stage_s = sum(dt for _, dt in st["stage_wall_s"])
            snap_s = sum(c["snapshot_s"] for c in sup.ckpt.records.values())
            res["cases"][case] = {"wall_s": wall, "launches": launches,
                                  "stage_log": list(log_),
                                  "stages_s": stage_s, "snapshots_s": snap_s,
                                  "restore": sup.ckpt.last_restore,
                                  "recovery": {k: (list(v) if isinstance(
                                      v, tuple) else v) for k, v in
                                      rec.items()}}
            restored = sup.ckpt.last_restore
            log(f"phase 14 ({case}): equal to phase 3's outputs; wall "
                f"{wall:.3f} s (committed stages {stage_s:.3f} s, snapshots "
                f"{snap_s:.3f} s"
                + (f", restore of {restored['bytes']} bytes "
                   f"{restored['seconds']:.3f} s" if restored else "")
                + f"); stages {', '.join(log_)}; recovery {rec}; launches "
                f"{launches}")
            return sup, st

        # the fingerprint a supervised solve pays for, alone
        succ_d = torch.from_numpy(succ_np).reshape(P_MAIN, -1).to(dev)
        rank_d = torch.from_numpy(rank_np).reshape(P_MAIN, -1).to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        resume.solve_fingerprint(succ_d, rank_d, succ_np.shape[0], P_MAIN,
                                 SEED, cfg_on)
        res["fingerprint_s"] = time.perf_counter() - t
        del succ_d, rank_d
        log(f"phase 14: the instance fingerprint (both arrays to the host, "
            f"sha256) {res['fingerprint_s']:.3f} s [{card}]")

        # (a) straight through on a fresh directory (phases 3 and 4 ran
        # the same solve: it is warm)
        sup, st = supervised("a", "a")
        if st["recovery"]["checkpoints"] != 6 or st["stage_log"] != (
                "prep", "descend@0", "descend@1", "base@2", "ascend@1",
                "ascend@0", "post"):
            fail(f"phase 14 (a): {st['recovery']['checkpoints']} checkpoints,"
                 f" stages {st['stage_log']}")
        res["launches"] = res["cases"]["a"]["launches"]
        labels = ("prep", "descend@0", "descend@1", "base@2", "ascend@1",
                  "ascend@0")
        res["checkpoints"] = {
            f"{idx} ({labels[idx - 1]})": rec
            for idx, rec in sorted(sup.ckpt.records.items())}
        for name, rec in res["checkpoints"].items():
            log(f"phase 14: boundary {name}: checkpoint of "
                f"{rec['bytes']} bytes ({rec['bytes'] / 1e9:.3f} GB), "
                f"snapshot (device to host) {rec['snapshot_s']:.3f} s, write "
                f"{rec['write_s']:.3f} s [{card}]")
        res["supervised_warm_s"] = res["cases"]["a"]["wall_s"]
        res["plain_warm_s"] = plain_warm_s
        log(f"phase 14: supervised solve warm {res['supervised_warm_s']:.3f} s "
            f"against phase 3's unsupervised warm {plain_warm_s:.3f} s "
            f"[{card}]")
        shutil.rmtree(root / "a")

        # (b) preempted after descend@1, resumed by a fresh supervisor;
        # (f) resumes a copy of the same checkpoint with kernels off
        sup, _ = supervised("b_preempted", "b", inject=FaultSpec(
            "preempt", stage="descend", level=1), preempted=True)
        if res["cases"]["b_preempted"]["preempted_at"] != 3:
            fail(f"phase 14 (b): preempted at boundary "
                 f"{res['cases']['b_preempted']['preempted_at']}, not 3")
        shutil.copytree(root / "b", root / "f")
        _, st = supervised("b", "b")
        if st["recovery"]["resumed_from"] != 3 or st["stage_log"] != (
                "base@2", "ascend@1", "ascend@0", "post"):
            fail(f"phase 14 (b): resumed {st['recovery']}, {st['stage_log']}")
        res["resume_s"] = res["cases"]["b"]["wall_s"]
        log(f"phase 14: resume from the descend@1 boundary (restore "
            f"included) {res['resume_s']:.3f} s against a full solve: "
            f"unsupervised {plain_warm_s:.3f} s, supervised "
            f"{res['supervised_warm_s']:.3f} s [{card}]")
        shutil.rmtree(root / "b")

        # (c) a PE lost before base@2
        _, st = supervised("c", "c", inject=FaultSpec("pe_loss", stage="base"))
        if st["recovery"]["resumed_from"] != 3 \
                or st["stage_log"].count("descend@0") != 1 \
                or st["stage_log"].count("base@2!InjectedFault") != 1:
            fail(f"phase 14 (c): {st['recovery']}, {st['stage_log']}")
        shutil.rmtree(root / "c")

        # (d) a corrupted plane after descend@0
        _, st = supervised("d", "d", inject=FaultSpec(
            "corrupt", stage="descend", level=0, pe=3, plane="succ"))
        if st["recovery"]["resumed_from"] != 1 \
                or st["stage_log"].count("descend@0!CorruptedState") != 1 \
                or st["stage_log"].count("prep") != 1:
            fail(f"phase 14 (d): {st['recovery']}, {st['stage_log']}")
        shutil.rmtree(root / "d")

        # (e) a forced gather overflow at base@2
        _, st = supervised("e", "e", inject=FaultSpec(
            "overflow", stage="base", level=2, family="gather"))
        log_ = st["stage_log"]
        if any(log_.count(k) != 1 for k in labels[:3] + labels[4:] +
               ("post", "base@2", "base@2!overflow")) or st["attempts"] != 2:
            fail(f"phase 14 (e): attempts {st['attempts']}, stages {log_}")
        shutil.rmtree(root / "e")

        # (f) (b)'s checkpoint, kernels off
        _, st = supervised("f", "f", cfg=cfg_off)
        if st["recovery"]["resumed_from"] != 3:
            fail(f"phase 14 (f): {st['recovery']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# --------------------------------------------------------------- phase 15
#: where phase 15 writes its Chrome trace (listed in .gitignore)
OBS_TRACE = ROOT / "chiprun_out" / "chip_smoke_obs_trace.json"
TREE_KEYS = ("depth", "subtree_size", "preorder", "postorder", "root_of")
GRAPH_KEYS = ("components", "parent", "depth", "subtree_size", "preorder",
              "postorder")


def obs_phase(dev, card: str, succ_np, rank_np, plain, cfg_on, cfg_off,
              plain_launches: dict, tree_out, graph_out, n_tree: int,
              n_graph: int, plain_warm_s: float) -> dict:
    """Phase 15: the flight recorder on the main, tree and graph paths;
    (e) holds its warm wall against phase 3's (``plain_warm_s``)."""
    import torch
    from repro_torch import devtime, obs
    from repro_torch.core import graphalg, treealg
    from repro_torch.core.listrank import (instances, rank_list_with_stats,
                                           resume, sim_mesh)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    counters = {"local_chase": lc_ops, "mailbox_pack": mp_ops,
                "flash_attention": fa_ops, "ssd_scan": ssd_ops}
    s_plain, r_plain, ints_plain = plain
    mesh = sim_mesh(P_MAIN)
    cfg_tele = cfg_on.with_(telemetry=True)
    res: dict = {}
    t_phase = time.perf_counter()

    def solve(cfg, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, r, st = rank_list_with_stats(succ_np, rank_np, mesh, cfg=cfg,
                                        seed=SEED, device=dev, **kw)
        torch.cuda.synchronize()
        return s, r, st, time.perf_counter() - t

    # (a) telemetry, stage counters and a tracer, kernels on
    for mod in counters.values():
        mod.LAUNCHES = 0
    tracer = obs.Tracer(meta={"name": "chip_smoke phase 15", "card": card})
    s_a, r_a, st_a, wall_a = solve(cfg_tele, tracer=tracer,
                                   stage_counters=True)
    res["launches"] = {k: mod.LAUNCHES for k, mod in counters.items()}
    if not (torch.equal(s_a, s_plain) and torch.equal(r_a, r_plain)):
        fail("phase 15 (a): outputs differ from phase 3's")
    if int_counters(st_a) != ints_plain:
        fail(f"phase 15 (a): counters {int_counters(st_a)} differ from "
             f"phase 3's {ints_plain}")
    want = {"local_chase": 1, "mailbox_pack": plain_launches["mailbox_pack"],
            "flash_attention": 0, "ssd_scan": 0}
    if res["launches"] != want:
        fail(f"phase 15 (a): launches {res['launches']}, phase 3's path "
             f"{want}")
    _, _, st_t, _ = solve(cfg_on, tracer=obs.Tracer(), stage_counters=True)
    if st_a["stage_collectives"] != st_t["stage_collectives"]:
        fail("phase 15 (a): the stages' collectives differ from a traced "
             "telemetry-off solve's")
    log(f"phase 15 (a): telemetry + tracer + stage counters, kernels on: "
        f"outputs and counters equal to phase 3's, stage collectives equal "
        f"to a traced telemetry-off solve's; launches {res['launches']}; "
        f"wall {wall_a:.3f} s [{card}]")

    # (b) kernels off: the same records
    for mod in counters.values():
        mod.LAUNCHES = 0
    s_b, r_b, st_b, _ = solve(cfg_off.with_(telemetry=True))
    if any(mod.LAUNCHES for mod in counters.values()):
        fail("phase 15 (b): kernels off, yet a kernel was launched")
    if not (torch.equal(s_b, s_plain) and torch.equal(r_b, r_plain)
            and int_counters(st_b) == ints_plain):
        fail("phase 15 (b): outputs or counters differ from phase 3's")
    if st_b["telemetry"]["stages"] != st_a["telemetry"]["stages"]:
        fail("phase 15 (b): stage records differ with the kernels off")
    log(f"phase 15 (b): kernels off: {len(st_b['telemetry']['stages'])} "
        f"stage records equal to (a)'s")

    # (c) the span tree, its Chrome trace, the tables
    sched = [stg.label for stg in resume.schedule_for(cfg_on)]
    if [sp.name for sp in tracer.find(cat="stage")] != sched:
        fail(f"phase 15 (c): stage spans "
             f"{[sp.name for sp in tracer.find(cat='stage')]}, schedule "
             f"{sched}")
    coll = dict(st_a["stage_collectives"])
    for att in tracer.find(cat="stage-attempt"):
        a = att.args
        if not np.isfinite(a.get("predicted_s", float("nan"))):
            fail(f"phase 15 (c): {att.name} has no finite predicted_s")
        if a["collective_count"] != sum(c for _, c in coll[a["stage"]]):
            fail(f"phase 15 (c): {att.name} counted "
                 f"{a['collective_count']} collectives, stage_collectives "
                 f"{coll[a['stage']]}")
    OBS_TRACE.parent.mkdir(parents=True, exist_ok=True)
    obs.write_chrome_trace(tracer, str(OBS_TRACE))
    doc = json.loads(OBS_TRACE.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    if len(xs) != len(tracer.spans):
        fail(f"phase 15 (c): the Chrome trace holds {len(xs)} spans of "
             f"{len(tracer.spans)}")
    rows = obs.residual_rows(tracer)
    res["residuals"] = rows
    res["residual_summary"] = obs.residual_summary(rows)
    res["headroom"] = st_a["telemetry"]["headroom"]
    log(f"phase 15 (c): span tree ({len(tracer.spans)} spans; Chrome trace "
        f"{os.path.relpath(OBS_TRACE, ROOT)}, read back):")
    for line in obs.span_tree_lines(tracer):
        log("  " + line)
    log(obs.format_residual_table(
        rows, title="phase 15 (c): measured wall against the alpha-beta "
        f"price of the executed collectives (SUPERMUC constants) [{card}]"))
    log("phase 15 (c): capacity headroom:")
    log(obs.format_headroom_table(res["headroom"]))

    # (d) the tree and graph paths, traced with telemetry on
    parent = instances.gen_tree_parents(n_tree, seed=SEED, locality=False)
    tr_tree = obs.Tracer()
    t = time.perf_counter()
    tree = treealg.tree_stats(parent, mesh, cfg=cfg_tele, seed=SEED,
                              device=dev, tracer=tr_tree)
    wall_tree = time.perf_counter() - t
    for k in TREE_KEYS:
        if not np.array_equal(getattr(tree, k), getattr(tree_out, k)):
            fail(f"phase 15 (d): tree {k} differs from phase 6's")
    (tour,) = tr_tree.find(name="build_tour")
    if not tour.args["telemetry"]["tele"]["graph"]["rounds"]:
        fail("phase 15 (d): the tour span carries no graph-family record")
    edges = instances.gen_graph_edges(n_graph, 4 * n_graph, seed=SEED,
                                      locality=False, num_components=4)
    tr_graph = obs.Tracer()
    t = time.perf_counter()
    gs = graphalg.graph_stats(edges, n_graph, mesh, cfg=cfg_tele, seed=SEED,
                              device=dev, tracer=tr_graph)
    wall_graph = time.perf_counter() - t
    for k in GRAPH_KEYS:
        if not np.array_equal(getattr(gs, k), getattr(graph_out, k)):
            fail(f"phase 15 (d): graph {k} differs from phase 7's")
    (rec,) = gs.stats["telemetry"]["stages"]
    if not rec["tele"]["graph"]["rounds"]:
        fail("phase 15 (d): the graph record has no graph-family rounds")
    esc = [i for i in tr_graph.instants
           if i.name == "escalate:graphalg:stats"]
    if len(esc) != gs.stats["attempts"] - 1:
        fail(f"phase 15 (d): {len(esc)} escalate instants for "
             f"{gs.stats['attempts']} attempts")
    rows_g = gs.stats["telemetry"]["headroom"]
    final = obs.telemetry.parse_scales(esc[-1].args["scales"]) if esc \
        else {}
    escalated = {f for f, v in final.items() if v > 1.0}
    if escalated and not any(r["family"] in escalated for r in rows_g):
        fail(f"phase 15 (d): no headroom row of the escalated families "
             f"{sorted(escalated)}")
    if any(r["scale"] <= 1.0 for r in rows_g if r["family"] in escalated):
        fail("phase 15 (d): a headroom row of an escalated family is not "
             "scaled")
    res["tree"] = {"wall_s": wall_tree,
                   "util_max": tour.args["telemetry"]["util_max"]}
    res["graph"] = {"wall_s": wall_graph, "attempts": gs.stats["attempts"],
                    "escalations": [i.args["scales"] for i in esc],
                    "util_max": rec["util_max"]}
    log(f"phase 15 (d): tree_stats n={n_tree} traced with telemetry: equal "
        f"to phase 6, tour record present, {wall_tree:.3f} s; graph_stats "
        f"n={n_graph}: equal to phase 7, {gs.stats['attempts']} attempts, "
        f"escalations {res['graph']['escalations']}, graph util_max "
        f"{rec['util_max']:.3f}, {wall_graph:.3f} s [{card}]")
    log(obs.format_headroom_table(rows_g))

    # (e) the cost: one warm wall against phase 3's warm rerun (stage
    # counters on; this phase's own plain solve was cut for the script's
    # time limit), device time on and off
    walls = {"plain": [plain_warm_s],
             "obs": [solve(cfg_tele, tracer=obs.Tracer(),
                           stage_counters=True)[3]]}
    res["walls_s"] = walls
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"phase 15 (e): warm wall: phase 3's rerun (stage counters) "
        f"{med['plain']:.4f} s, telemetry + tracer + counters "
        f"{med['obs']:.4f} s; overhead "
        f"{med['obs'] - med['plain']:+.4f} s "
        f"({100 * (med['obs'] / med['plain'] - 1):+.2f} %) [{card}]")
    # the device-time windows hold one solve of List(N_GRID): a hop's
    # telemetry launches do not depend on n, and a window of the 2^24
    # solve cost about 20 s (two to three windows each for repeat_check)
    succ_w, rank_w = instances.gen_list(N_GRID, gamma=1.0, seed=2)

    def small_solve(cfg):
        return rank_list_with_stats(succ_w, rank_w, mesh, cfg=cfg,
                                    seed=SEED, device=dev)

    dev_res = {}
    for name, cfg in (("plain", cfg_on), ("telemetry", cfg_tele)):
        kt, events, _ = devtime.kernel_times_over(
            lambda: small_solve(cfg), torch, log=log)
        dev_res[name] = {"busy_ms": kt["busy_ms"],
                         "device_events": None if events is None
                         else len(events),
                         "idle_share": kt["idle_share"],
                         "profiled_wall_s": kt["profiled_wall_s"]}
    res["device"] = dev_res
    p_, t_ = dev_res["plain"], dev_res["telemetry"]
    if p_["busy_ms"] is None or t_["busy_ms"] is None:
        log(f"phase 15 (e): device time of one List({N_GRID}) solve not "
            f"measured (plain {p_['busy_ms']}, telemetry {t_['busy_ms']})")
    else:
        log(f"phase 15 (e): device time of one List({N_GRID}) solve "
            f"(torch.profiler): "
            f"plain {p_['busy_ms']:.1f} ms in {p_['device_events']} device "
            f"events, telemetry on {t_['busy_ms']:.1f} ms in "
            f"{t_['device_events']}: {t_['busy_ms'] - p_['busy_ms']:+.1f} ms, "
            f"{t_['device_events'] - p_['device_events']:+d} device events "
            f"[{card}]")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {res['phase_s']:.1f} s")
    return res



# --------------------------------------------------------------- phase 16
#: (b)'s processes on the one card, PEs per process P_MAIN / DIST_WORLD
DIST_WORLD = 4
#: (c)'s sizes under (b)'s layout: tree nodes, graph nodes (edges 4x)
DIST_TREE, DIST_GRAPH = 1 << 18, 1 << 14
#: seconds the parent waits for (b)'s ranks, start-up included
DIST_TIMEOUT_S = 300
#: (a)'s and (b)'s backends (a CPU rehearsal runs both on gloo)
DIST_BACKENDS = {"a": "nccl", "b": "gloo"}


def _digest(*arrays) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _synchronize(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_collectives(dist, torch, dev):
    """Wrap the three collectives the transport calls so that each is
    timed between two device synchronisations (the first waits for the
    work queued before it); returns the accumulator and an undo."""
    acc = {"s": 0.0, "calls": 0}
    names = ("all_to_all_single", "all_reduce", "all_gather_into_tensor",
             "all_gather_single")
    saved = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def timed(fn):
        def call(*a, **kw):
            _synchronize(torch, dev)
            t = time.perf_counter()
            out = fn(*a, **kw)
            _synchronize(torch, dev)
            acc["s"] += time.perf_counter() - t
            acc["calls"] += 1
            return out
        return call

    for n, fn in saved.items():
        setattr(dist, n, timed(fn))

    def undo():
        for n, fn in saved.items():
            setattr(dist, n, fn)
    return acc, undo


def _dist_rank(rank: int, world: int, init: str, work: str, device: str,
               sizes: tuple, queue) -> None:
    """One process of phase 16 (b) and (c): gloo over tensors on
    ``device`` (card 0), ``P_MAIN // world`` PEs; puts its result (or
    its traceback) on ``queue``."""
    import datetime
    import traceback
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            DIST_BACKENDS["b"], init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        try:
            queue.put((rank, True, _dist_rank_work(dev, work, sizes, torch,
                                                   dist)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent fails the phase with this traceback
        queue.put((rank, False, traceback.format_exc()))


def _dist_rank_work(dev, work: str, sizes: tuple, torch, dist) -> dict:
    from repro_torch.core import graphalg, treealg
    from repro_torch.core.listrank import (ListRankConfig, dist_mesh,
                                           instances, rank_list_with_stats)
    work = pathlib.Path(work)
    succ = np.load(work / "succ.npy")
    rank_in = np.load(work / "rank.npy")
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    mesh = dist_mesh(P_MAIN)
    ops = kernel_ops()
    out = {"pes": list(range(dist.get_rank() * mesh.pes_per_rank,
                             (dist.get_rank() + 1) * mesh.pes_per_rank))}

    def solve(**kw):
        dist.barrier()
        _synchronize(torch, dev)
        t = time.perf_counter()
        s, r, st = rank_list_with_stats(succ, rank_in, mesh, cfg=cfg,
                                        seed=SEED, device=dev, **kw)
        _synchronize(torch, dev)
        return s, r, st, time.perf_counter() - t

    for mod in ops.values():
        mod.LAUNCHES = 0
    s, r, st, cold = solve(stage_counters=True)
    out["launches"] = {name: mod.LAUNCHES for name, mod in ops.items()}
    out.update(cold_wall_s=cold, digest=_digest(s.cpu().numpy(),
                                                r.cpu().numpy()),
               counters=int_counters(st),
               stage_collectives=st["stage_collectives"])
    # the warm solve, with each collective timed (a warm solve without the
    # timers was cut for the script's time limit)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    acc, undo = _timed_collectives(dist, torch, dev)
    try:
        s2, r2, _, timed_wall = solve()
    finally:
        undo()
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else 0)
    out.update(timed_wall_s=timed_wall, collective_s=acc["s"],
               collective_calls=acc["calls"],
               timed_digest=_digest(s2.cpu().numpy(), r2.cpu().numpy()))

    # (c) the tree and graph paths under the same layout
    n_tree, n_graph = sizes
    parent = instances.gen_tree_parents(n_tree, seed=SEED, locality=False)
    t = time.perf_counter()
    ts = treealg.tree_stats(parent, mesh, cfg=cfg, seed=SEED, device=dev)
    out["tree_wall_s"] = time.perf_counter() - t
    out["tree_digest"] = _digest(*(getattr(ts, k) for k in TREE_KEYS))
    edges = instances.gen_graph_edges(n_graph, 4 * n_graph, seed=SEED,
                                      locality=False, num_components=4)
    t = time.perf_counter()
    gs = graphalg.graph_stats(edges, n_graph, mesh, cfg=cfg, seed=SEED,
                              device=dev)
    out["graph_wall_s"] = time.perf_counter() - t
    out["graph_digest"] = _digest(*(getattr(gs, k) for k in GRAPH_KEYS))
    out["graph_attempts"] = gs.stats["attempts"]
    return out


def _run_ranks(world: int, work: pathlib.Path, device: str, sizes: tuple,
               timeout_s: float, target=None, phase: str = "16 (b)") -> list:
    """Spawn ``world`` ranks of ``target`` (:func:`_dist_rank` unless
    given), join them with a timeout; every rank's result in rank order,
    or phase ``phase`` fails."""
    import multiprocessing as mp
    import queue as queue_lib
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{work / 'store'}"
    procs = [ctx.Process(target=target or _dist_rank,
                         args=(r, world, init, str(work), device, sizes,
                               results))
             for r in range(world)]
    for pr in procs:
        pr.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = {r: pr.exitcode for r, pr in enumerate(procs)
                        if pr.exitcode not in (None, 0)}
                if dead:
                    fail(f"phase {phase}: ranks exited {dead}")
                if time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(got))
                    fail(f"phase {phase}: ranks {missing} gave no result "
                         f"within {timeout_s} s")
                continue
            if not ok:
                fail(f"phase {phase}: rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for pr in procs:
            pr.join(timeout=30)
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=30)
    return [got[r] for r in range(world)]


def dist_phase(dev, card: str, succ_np, rank_np, plain, cfg_on,
               plain_launches: dict, plain_collectives, plain_warm_s: float,
               world: int = DIST_WORLD, n_tree: int = DIST_TREE,
               n_graph: int = DIST_GRAPH) -> dict:
    """Phase 16: the torch.distributed transport on the one card."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import devtime
    from repro_torch.core import graphalg, treealg
    from repro_torch.core.listrank import (dist_mesh, instances,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch.core.listrank import transport as transport_lib

    s_plain, r_plain, ints_plain = plain
    ops = kernel_ops()
    # phase 3's list path; the LM kernels are not on it
    want_launches = {**plain_launches, "flash_attention": 0, "ssd_scan": 0}
    res: dict = {}
    t_phase = time.perf_counter()

    # (a) NCCL at world size 1: every PE on this process's one rank
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(DIST_BACKENDS["a"],
                                init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = dist_mesh(P_MAIN)

            def solve(**kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                s, r, st = rank_list_with_stats(
                    succ_np, rank_np, mesh, cfg=cfg_on, seed=SEED,
                    device=dev, **kw)
                torch.cuda.synchronize()
                return s, r, st, time.perf_counter() - t

            for mod in ops.values():
                mod.LAUNCHES = 0
            s_a, r_a, st_a, cold = solve(stage_counters=True)
            launches = {name: mod.LAUNCHES for name, mod in ops.items()}
            if not (torch.equal(s_a, s_plain) and torch.equal(r_a, r_plain)):
                fail("phase 16 (a): outputs differ from phase 3's")
            if int_counters(st_a) != ints_plain:
                fail(f"phase 16 (a): counters {int_counters(st_a)} differ "
                     f"from phase 3's {ints_plain}")
            if st_a["stage_collectives"] != plain_collectives:
                fail(f"phase 16 (a): stage collectives "
                     f"{st_a['stage_collectives']} differ from phase 3's "
                     f"{plain_collectives}")
            if launches != want_launches:
                fail(f"phase 16 (a): launches {launches}, phase 3's "
                     f"{want_launches}")
            # the warm solve: with each collective timed (a warm solve
            # without the timers was cut for the script's time limit)
            acc, undo = _timed_collectives(dist, torch, dev)
            try:
                timed = solve()[3]
            finally:
                undo()
            # one level-0 hop's collectives through NCCL, under the profiler
            tr = transport_lib.DistTransport.for_mesh(mesh, ("pe",), dev)
            hop = torch.zeros((P_MAIN, 5, P_MAIN, 4096), dtype=torch.int32,
                              device=dev)
            cnt = torch.ones(P_MAIN, dtype=torch.int32, device=dev)

            def hop_calls():
                tr.all_to_all(hop, ("pe",), 1)
                tr.psum(cnt)
                tr.gather_pes(cnt)

            hop_calls()
            _, events, _ = devtime.window(
                hop_calls, torch, cats=devtime.DEVICE_CATS + (
                    "cpu_op", "user_annotation", "gpu_user_annotation"))
        finally:
            dist.destroy_process_group()
    nccl_calls = sorted({e["name"] for e in events
                         if e["name"].startswith("nccl:")})
    if not nccl_calls:
        fail("phase 16 (a): the window holds no NCCL call")
    device = [e for e in events if e["cat"] in devtime.DEVICE_CATS]
    by_name = {f"{k[:48]} (stream {e['tid']})": v
               for k, v in devtime.per_name(device).items()
               for e in device if e["name"] == k}
    res["nccl"] = {"launches": launches, "cold_wall_s": cold,
                   "timed_wall_s": timed,
                   "collective_s": acc["s"], "collective_calls": acc["calls"],
                   "hop_nccl_calls": nccl_calls,
                   "hop_device_events": by_name}
    log(f"phase 16 (a): NCCL, world size 1, {P_MAIN} PEs on one rank, "
        f"kernels on: outputs, counters and stage collectives equal to "
        f"phase 3's; launches {launches}; cold {cold:.3f} s; warm, with "
        f"each collective timed between syncs, {timed:.3f} s against phase "
        f"3's {plain_warm_s:.3f} s, of it {acc['s']:.3f} s in "
        f"{acc['calls']} collectives [{card}]")
    log(f"phase 16 (a): one hop's all_to_all, psum and gather under the "
        f"profiler: NCCL calls {nccl_calls}; device events (count, us) "
        f"{by_name}")

    # (c)'s references: the virtual transport on the same inputs
    parent = instances.gen_tree_parents(n_tree, seed=SEED, locality=False)
    ts = treealg.tree_stats(parent, sim_mesh(P_MAIN), cfg=cfg_on,
                            seed=SEED, device=dev)
    tree_digest = _digest(*(getattr(ts, k) for k in TREE_KEYS))
    edges = instances.gen_graph_edges(n_graph, 4 * n_graph, seed=SEED,
                                      locality=False, num_components=4)
    gs = graphalg.graph_stats(edges, n_graph, sim_mesh(P_MAIN),
                              cfg=cfg_on, seed=SEED, device=dev)
    graph_digest = _digest(*(getattr(gs, k) for k in GRAPH_KEYS))
    del ts, gs

    # (b) gloo with CUDA tensors: `world` processes share the card
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    digest = _digest(s_plain.cpu().numpy(), r_plain.cpu().numpy())
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        np.save(work / "succ.npy", succ_np)
        np.save(work / "rank.npy", rank_np)
        t = time.perf_counter()
        outs = _run_ranks(world, work, str(dev), (n_tree, n_graph),
                          DIST_TIMEOUT_S)
        ranks_s = time.perf_counter() - t
    for r, out in enumerate(outs):
        if out["digest"] != digest or out["timed_digest"] != digest:
            fail(f"phase 16 (b): rank {r}'s outputs differ from phase 3's")
        if out["counters"] != ints_plain:
            fail(f"phase 16 (b): rank {r}'s counters {out['counters']} "
                 f"differ from phase 3's {ints_plain}")
        if out["stage_collectives"] != plain_collectives:
            fail(f"phase 16 (b): rank {r}'s stage collectives differ from "
                 f"phase 3's")
        if out["launches"] != want_launches:
            fail(f"phase 16 (b): rank {r} launched {out['launches']}, "
                 f"phase 3's path {want_launches}")
        if out["tree_digest"] != tree_digest:
            fail(f"phase 16 (c): rank {r}'s tree_stats differ from the "
                 f"virtual transport's")
        if out["graph_digest"] != graph_digest:
            fail(f"phase 16 (c): rank {r}'s graph_stats differ from the "
                 f"virtual transport's")
    res["gloo"] = {"world": world, "launches": outs[0]["launches"],
                   "ranks": outs, "ranks_s": ranks_s}
    for r, out in enumerate(outs):
        log(f"phase 16 (b): gloo rank {r} (PEs {out['pes'][0]}.."
            f"{out['pes'][-1]}): outputs, counters and stage collectives "
            f"equal to phase 3's; launches {out['launches']}; cold "
            f"{out['cold_wall_s']:.3f} s; warm, with each collective timed "
            f"between syncs, {out['timed_wall_s']:.3f} s, of it "
            f"{out['collective_s']:.3f} s in {out['collective_calls']} "
            f"collectives, peak {out['peak_memory_bytes'] / 2**30:.2f} GiB "
            f"[{card}]")
    log(f"phase 16 (c): tree_stats n={n_tree} and graph_stats n={n_graph} "
        f"under {world} gloo ranks equal the virtual transport's; walls "
        f"(rank 0) tree {outs[0]['tree_wall_s']:.3f} s, graph "
        f"{outs[0]['graph_wall_s']:.3f} s in {outs[0]['graph_attempts']} "
        f"attempts; the ranks took {ranks_s:.1f} s with start-up [{card}]")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {res['phase_s']:.1f} s")
    return res


# --------------------------------------------------------------- phase 17
#: the SSM serving phase's models: (arch, max_seq, longest prompt, the
#: exactness prompt's length)
SSM_SERVE = (("mamba2-130m", 2048, 1024, 1000), ("hymba-1.5b", 4096, 3000,
                                                 1500))
#: hymba's attention: Hq, Hkv, D, window; its prefill lengths (Lq = Lk)
HYMBA_ATTN, HYMBA_PREFILL_L = (25, 5, 64, 1024), (2048, 4096)
#: hymba's split-K decode: per-slot offsets around the window's edge, Lk
HYMBA_DECODE_OFFSETS, HYMBA_DECODE_LK = (100, 1023, 1024, 1025, 3000,
                                         4095), 4096
#: hymba's SSD shape: (Bt, L, H, G, N, P, chunk)
HYMBA_SSD = (1, 4096, 50, 1, 16, 64, 128)


def ops_rate(dt, torch) -> float:
    """The card's peak operations a second for inputs of dtype ``dt``: the
    bf16 tensor cores, or float32 outside them."""
    from repro_torch.devtime import BF16_OPS_PER_S, FP32_OPS_PER_S
    return BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S


def window_mask(lq, lk, offsets, window, dev, torch):
    """(B, 1, Lq, Lk) bool: causal from each row's offset, the last
    ``window`` keys kept (SDPA's mask for the windowed attention)."""
    pos = torch.tensor(offsets, device=dev)[:, None] + torch.arange(
        lq, device=dev)
    key = torch.arange(lk, device=dev)
    keep = (key <= pos[..., None]) & (key > pos[..., None] - window)
    return keep[:, None]


def ssm_kernels_phase(dev) -> tuple[dict, dict]:
    """Phase 17 (a): ``flash_attention`` and ``ssd_scan`` at hymba's shapes
    against their plain versions, with kernel, plain and (attention) SDPA
    times and the kernel's bound. Returns (flash rows, ssd rows)."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import ATTN_TOL, SSD_TOL, ssd_inputs
    from repro_torch import devtime
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    hq, hkv, d, win = HYMBA_ATTN
    g = torch.Generator(device=dev).manual_seed(17)
    cases = [("prefill", l, dt, 1, l, [0]) for l in HYMBA_PREFILL_L
             for dt in (torch.bfloat16, torch.float32)]
    cases.append(("decode", 1, torch.bfloat16, len(HYMBA_DECODE_OFFSETS),
                  HYMBA_DECODE_LK, list(HYMBA_DECODE_OFFSETS)))
    fa_rows = {}
    for kind, lq, dt, b, lk, offs in cases:
        q = torch.randn((b, hq, lq, d), generator=g, device=dev).to(dt)
        k = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)
        v = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)
        off = offs[0] if kind == "prefill" else torch.tensor(
            offs, dtype=torch.int32, device=dev)
        kw = dict(window=win, q_offset=off)
        mask = window_mask(lq, lk, offs, win, dev, torch)

        def library_call():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        out = fa_ops.flash_attention(q, k, v, **kw).float()
        want = fa_ref.attention_ref(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = max_abs_err(out, want, torch)
        name = f"{kind}_{lq if kind == 'prefill' else lk}_" \
            f"{str(dt).removeprefix('torch.')}"
        if not torch.allclose(out, want, **ATTN_TOL[dt]):
            fail(f"phase 17 (a): flash_attention {name} differs from its "
                 f"plain version by {err}")
        if kind == "decode":
            parts = fa_ref.attention_split_ref(
                q, k, v, part_len=fa_ops.decode_part_len(
                    lk, fa_ops.decode_splits(
                        b, hkv, hq // hkv, lk, torch.cuda
                        .get_device_properties(dev).multi_processor_count)),
                **kw).float()
            if not torch.allclose(out, parts, **ATTN_TOL[dt]):
                fail("phase 17 (a): the split-K decode differs from its plain "
                     f"split-and-merge by {max_abs_err(out, parts, torch)}")
        lib = library_call().float()
        if not torch.allclose(lib, want, **ATTN_TOL[torch.bfloat16]):
            fail(f"phase 17 (a): the SDPA yardstick computes another "
                 f"function ({name}: {max_abs_err(lib, want, torch)})")
        del out, want, lib
        ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), torch)
        plain = time_ms(lambda: fa_ref.attention_ref(q, k, v, **kw), torch,
                        reps=5)
        lib_ms = time_ms(library_call, torch, reps=5)
        kname = "f32" if dt == torch.float32 else f"{kind}_bf16"
        dev_ms = device_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                           torch, devtime.EXPECT[f"flash_attention_{kname}"])
        bnd, by = attention_bound(b, hq, hkv, lq, d, offs, lk,
                                  q.element_size(), window=win,
                                  ops_per_s=ops_rate(dt, torch))
        fa_rows[name] = {"b": b, "lq": lq, "lk": lk, "offsets": offs,
                         "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                         "plain_ms": plain, "library_ms": lib_ms,
                         "bound_ms": bnd, "bound_by": by}
        log(f"phase 17 (a): flash_attention {name} B={b} Hq={hq} Hkv={hkv} "
            f"D={d} window={win} Lq={lq} Lk={lk}"
            + (f" offsets {offs}" if kind == "decode" else "")
            + f": max |err| {err:.3g} (tolerance {ATTN_TOL[dt]}); kernel "
              f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}), plain "
              f"{plain:.4f} ms, SDPA (masked) {lib_ms:.4f} ms, bound "
              f"{bnd:.4f} ms by {by}")
        del q, k, v, mask
    torch.cuda.empty_cache()

    bt, l, h, gr, n, p, chunk = HYMBA_SSD
    ssd_rows = {}
    for dt, tol in ((torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
                    (torch.float32, SSD_TOL)):
        name = str(dt).removeprefix("torch.")
        args = [t.to(dev) for t in ssd_inputs(bt, l, h, gr, n, p, seed=17,
                                              dtype=dt)]
        out = ssd_ops.ssd_scan(*args, chunk)
        want = ssd_ref.ssd_ref(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out.float(), want.float(), torch)
        if not torch.allclose(out.float(), want.float(), **tol):
            fail(f"phase 17 (a): ssd_scan {name} at hymba's shape differs "
                 f"from its plain version by {err}")
        ms = time_ms(lambda: ssd_ops.ssd_scan(*args, chunk), torch)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        dev_ms = device_ms(lambda: ssd_ops.ssd_scan(*args, chunk), torch,
                           devtime.EXPECT[f"ssd_scan_{kind}"])
        plain = time_ms(lambda: ssd_ref.ssd_chunked_ref(*args, chunk=chunk),
                        torch, reps=5)
        bnd, by = ssd_bound(*HYMBA_SSD, args[0].element_size(),
                            ops_per_s=ops_rate(dt, torch))
        ssd_rows[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                          "plain_ms": plain, "bound_ms": bnd, "bound_by": by}
        log(f"phase 17 (a): ssd_scan {name} Bt={bt} L={l} H={h} P={p} G={gr} "
            f"N={n} Q={chunk}: max |err| {err:.3g} (tolerance {tol}); kernel "
            f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}), ssd_chunked_ref "
            f"{plain:.4f} ms, bound {bnd:.4f} ms by {by}")
        del out, want, args
    torch.cuda.empty_cache()
    return fa_rows, ssd_rows


def ssm_serve_phase(dev, arch: str, max_seq: int, max_prompt: int) -> dict:
    """Phase 17 (b), (c): ``arch`` at full width and depth (bfloat16,
    kernels on) served through the engine. mamba2-130m's serving path
    launches no kernel (the reference's: the prefill through
    ``ssd_chunked_ref``, the decode through ``ssd_decode_step``); hymba's
    launches ``flash_attention`` on every attention call."""
    from repro_torch import configs

    cfg = configs.get_config(arch).with_(use_kernels=True)
    part = "b" if cfg.family == "mamba" else "c"
    res = serve_traffic(dev, 17, cfg, max_seq, max_prompt)
    launches = res["launches"]
    if launches["ssd_scan"] or launches["local_chase"] \
            or launches["mailbox_pack"]:
        fail(f"phase 17 ({part}): {cfg.name}'s serving path launched "
             f"{launches}")
    if cfg.family == "mamba":
        if launches["flash_attention"]:
            fail(f"phase 17 (b): {cfg.name} launched flash_attention")
        log(f"phase 17 (b): {cfg.name} serves as the reference does, through "
            "no kernel: the prefill through ssd_chunked_ref, the decode "
            "through ssd_decode_step (plain torch)")
    else:
        need = cfg.num_layers * (res["prefills"] + res["decode_ticks"])
        if launches["flash_attention"] < need:
            fail(f"phase 17 (c): flash_attention launched "
                 f"{launches['flash_attention']} times, the path has {need} "
                 "attention calls")
        log(f"phase 17 (c): flash_attention launches "
            f"{launches['flash_attention']} >= {need} (every attention call, "
            f"window {cfg.local_window} on {sum(cfg.is_local_flags)} of "
            f"{cfg.num_layers} layers); ssd_scan 0: the SSM branch serves "
            "through ssd_chunked_ref and ssd_decode_step, as in the "
            "reference")
    return res


def ssm_exactness_phase(dev) -> dict:
    """Phase 17 (d): in float32 (TF32 off), kernels on, the engine's path —
    its admission's prefill with the valid length, then the last prompt
    token and 16 teacher-forced tokens through ``decode_step`` — against
    ``forward`` on the same tokens (right-padded to a whole number of SSD
    chunks: causal, so the padding changes no kept logit); and hymba's
    forward with kernels on against off."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, res = 16, {}
    for arch, max_seq, _, plen in SSM_SERVE:
        cfg = configs.get_config(arch).with_(dtype=torch.float32,
                                             use_kernels=True)
        params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
        rng = np.random.default_rng(7)
        toks = rng.integers(2, cfg.vocab_size, plen + steps).astype(np.int32)
        eng = ServingEngine(params, cfg, ServeConfig(
            slots=1, max_seq=max_seq, max_new_tokens=steps), device=dev)
        eng.submit(Request(uid=0, prompt=toks[:plen]))
        fa_ops.LAUNCHES = ssd_ops.LAUNCHES = 0
        eng._admit()
        if eng.pos[0] != plen - 1:
            fail(f"phase 17 (d): admission left position {eng.pos[0]}")
        got = []
        for i in range(plen - 1, plen + steps):
            lg, _ = M.decode_step(params, torch.from_numpy(
                toks[i:i + 1]).to(dev)[None], i, cfg, eng.cache)
            got.append(lg[:, 0])
        got = torch.cat(got)
        path_launches = {"flash_attention": fa_ops.LAUNCHES,
                         "ssd_scan": ssd_ops.LAUNCHES}
        total = plen + steps
        padded = -(-total // cfg.ssm_chunk) * cfg.ssm_chunk
        batch = np.zeros((1, padded), np.int32)
        batch[0, :total] = toks
        batch = {"tokens": torch.from_numpy(batch).to(dev)}
        with torch.no_grad():
            full, _ = M.forward(params, batch, cfg)
        want = full[0, plen - 1:total]
        torch.cuda.synchronize()
        diff = max_abs_err(got, want, torch)
        row = {"prompt": plen, "steps": steps, "max_abs_diff": diff,
               "launches": path_launches}
        log(f"phase 17 (d): {cfg.name} float32, kernels on: admission "
            f"prefill of a {plen}-token prompt (valid length {plen - 1}) + "
            f"{steps + 1} decode steps against forward: max |logits diff| "
            f"{diff:.3g}; launches {path_launches}")
        if not torch.allclose(got, want, atol=2e-3, rtol=1e-3):
            fail(f"phase 17 (d): {cfg.name}'s engine path differs from "
                 f"forward by {diff}")
        if cfg.family == "hybrid":
            with torch.no_grad():
                off, _ = M.forward(params, batch, cfg.with_(use_kernels=False))
            torch.cuda.synchronize()
            row["forward_on_off_max_abs_diff"] = d_on_off = max_abs_err(
                full[0, :total], off[0, :total], torch)
            log(f"phase 17 (d): {cfg.name} forward on {total} tokens, "
                f"kernels on against off: max |logits diff| {d_on_off:.3g}")
            if not torch.allclose(full[0, :total], off[0, :total], atol=2e-3,
                                  rtol=1e-3):
                fail(f"phase 17 (d): {cfg.name}'s forward with kernels on "
                     f"differs from off by {d_on_off}")
            del off
        res[arch] = row
        del params, eng, full, got, want
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------- phase 18
MOE_ARCH, ENCDEC_ARCH = "granite-moe-1b-a400m", "seamless-m4t-medium"
#: seamless's attention: (Hq, Hkv, D); the batch; the encoder's frames; the
#: cross prefill's target positions; the cross decode's key counts
SEAMLESS_ATTN, SEAMLESS_B, SEAMLESS_LS, SEAMLESS_LT = (16, 16, 64), 8, 1024, 256
SEAMLESS_DECODE_LK = (1000, 1024)
#: the encdec run: batch, frames, target prompt tokens, greedy steps
ENCDEC_RUN = (8, 1024, 64, 32)
#: granite-moe's attention: (Hq, Hkv, D); the engine's prefill buckets
#: (the smallest and the largest of (b)); the decode's per-slot offsets
#: (where (b)'s slots are: prompts of 32..1024 tokens, 32 new tokens)
GRANITE_ATTN, GRANITE_PREFILL_L = (16, 8, 64), (128, 1024)
GRANITE_DECODE_OFFSETS = (31, 64, 255, 511, 1000, 1023, 1024, 1055)
#: the SMOKE models whose forward is held kernels on against off
EXACT_ARCHS = (MOE_ARCH, "kimi-k2-1t-a32b", ENCDEC_ARCH)
#: the engine check's traffic: slots, max_seq, new tokens, prompt lengths
EXACT_SERVE = (2, 256, 6, (72, 3, 150, 129, 21))


def cross_bound(b, hq, hkv, lq, lk, d, elem_bytes, ops_per_s):
    """(bound ms, what bounds it) of non-causal attention: 4*D operations
    per (q, k) pair at ``ops_per_s``; q, o, k and v each moved once."""
    from repro_torch.devtime import bound_ms
    nbytes = elem_bytes * (2 * b * hq * lq * d + 2 * b * hkv * lk * d)
    return bound_ms(nbytes, 4 * b * hq * lq * lk * d, ops_per_s)


def moe_encdec_kernels_phase(dev) -> dict:
    """Phase 18 (a): ``flash_attention`` at every attention shape that (b)
    and (c) give it, against its plain version (a decode also against its
    plain split-and-merge), with kernel, plain and SDPA times, device time
    and the bound. Returns the rows by model and case."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import ATTN_TOL
    from repro_torch import devtime
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    bf16, f32 = torch.bfloat16, torch.float32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(18)
    b, ls, lt = SEAMLESS_B, SEAMLESS_LS, SEAMLESS_LT
    _, _, prompt, steps = ENCDEC_RUN
    # (model, kind, heads, B, Lq, Lk, causal, offsets (None: one int),
    # dtypes)
    cases = [("seamless", "encoder", SEAMLESS_ATTN, b, ls, ls, False, [0],
              (bf16, f32)),
             ("seamless", "cross_prefill", SEAMLESS_ATTN, b, lt, ls, False,
              [0], (bf16, f32))]
    cases += [("seamless", "cross_decode", SEAMLESS_ATTN, b, 1, lk, False,
               [0], (bf16, f32)) for lk in SEAMLESS_DECODE_LK]
    cases.append(("seamless", "self_prefill", SEAMLESS_ATTN, b, prompt,
                  prompt + steps, True, [0], (bf16,)))
    cases += [("seamless", f"self_decode_at{off}", SEAMLESS_ATTN, b, 1,
               prompt + steps, True, [off], (bf16,))
              for off in (prompt, prompt + steps - 1)]
    cases += [("granite", "prefill", GRANITE_ATTN, 1, lq, SERVE_MAX_SEQ, True,
               [0], (bf16,)) for lq in GRANITE_PREFILL_L]
    cases.append(("granite", "decode", GRANITE_ATTN, SERVE_SLOTS, 1,
                  SERVE_MAX_SEQ, True, list(GRANITE_DECODE_OFFSETS), (bf16,)))
    rows: dict = {"seamless": {}, "granite": {}}
    for model, kind, (hq, hkv, d), b, lq, lk, causal, offs, dts in cases:
        per_slot = len(offs) > 1
        offs = offs * (1 if per_slot else b)
        off = torch.tensor(offs, dtype=torch.int32, device=dev) if per_slot \
            else offs[0]
        kw = dict(causal=causal, q_offset=off)
        mask = None
        if causal:
            pos = torch.tensor(offs, device=dev)[:, None] + torch.arange(
                lq, device=dev)
            mask = (torch.arange(lk, device=dev) <= pos[..., None])[:, None]
        for dt in dts:
            q = torch.randn((b, hq, lq, d), generator=g, device=dev).to(dt)
            k = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)
            v = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)

            def library_call():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=hq != hkv)

            out = fa_ops.flash_attention(q, k, v, **kw).float()
            want = fa_ref.attention_ref(q, k, v, **kw).float()
            torch.cuda.synchronize()
            err = max_abs_err(out, want, torch)
            name = f"{kind}_{lq}x{lk}_{str(dt).removeprefix('torch.')}"
            if not torch.allclose(out, want, **ATTN_TOL[dt]):
                fail(f"phase 18 (a): flash_attention {model} {name} differs "
                     f"from its plain version by {err}")
            if lq == 1 and dt == bf16:
                parts = fa_ref.attention_split_ref(
                    q, k, v, part_len=fa_ops.decode_part_len(
                        lk, fa_ops.decode_splits(b, hkv, hq // hkv, lk,
                                                 n_sm)), **kw).float()
                if not torch.allclose(out, parts, **ATTN_TOL[dt]):
                    fail(f"phase 18 (a): the split-K decode {model} {name} "
                         "differs from its plain split-and-merge by "
                         f"{max_abs_err(out, parts, torch)}")
            lib = library_call().float()
            if not torch.allclose(lib, want, **ATTN_TOL[bf16]):
                fail(f"phase 18 (a): the SDPA yardstick computes another "
                     f"function ({model} {name}: "
                     f"{max_abs_err(lib, want, torch)})")
            del out, want, lib
            ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), torch)
            plain = time_ms(lambda: fa_ref.attention_ref(q, k, v, **kw),
                            torch, reps=5)
            lib_ms = time_ms(library_call, torch, reps=5)
            kname = "f32" if dt == f32 else \
                ("decode_bf16" if lq == 1 else "prefill_bf16")
            dev_ms = device_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                               torch, devtime.EXPECT[f"flash_attention_{kname}"])
            if causal:
                bnd, by = attention_bound(b, hq, hkv, lq, d, offs, lk,
                                          q.element_size(),
                                          ops_per_s=ops_rate(dt, torch))
            else:
                bnd, by = cross_bound(b, hq, hkv, lq, lk, d, q.element_size(),
                                      ops_rate(dt, torch))
            rows[model][name] = {
                "b": b, "hq": hq, "hkv": hkv, "lq": lq, "lk": lk,
                "causal": causal, "offsets": offs, "max_abs_err": err,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by}
            log(f"phase 18 (a): flash_attention {model} {name} B={b} Hq={hq} "
                f"Hkv={hkv} D={d} {'causal' if causal else 'non-causal'} "
                f"Lq={lq} Lk={lk}"
                + (f" offsets {offs}" if causal and lq == 1 else "")
                + f": max |err| {err:.3g} (tolerance {ATTN_TOL[dt]}); kernel "
                  f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}), plain "
                  f"{plain:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bnd:.4f} ms "
                  f"by {by}")
            del q, k, v
        del mask
    torch.cuda.empty_cache()
    return rows


def moe_serve_phase(dev) -> dict:
    """Phase 18 (b): granite-moe-1b at full width and depth (bfloat16,
    kernels on) served through the engine with phase 17's traffic: the
    single-program MoE dispatch on every layer, ``flash_attention`` on
    every attention call and no other kernel."""
    from repro_torch import configs

    cfg = configs.get_config(MOE_ARCH).with_(use_kernels=True)
    res = serve_traffic(dev, 18, cfg, SERVE_MAX_SEQ, 1024)
    launches = res["launches"]
    need = cfg.num_layers * (res["prefills"] + res["decode_ticks"])
    if launches["flash_attention"] != need or any(
            n for name, n in launches.items() if name != "flash_attention"):
        fail(f"phase 18 (b): {cfg.name}'s serving path launched {launches}; "
             f"its {need} attention calls launch flash_attention, and "
             "nothing else launches")
    log(f"phase 18 (b): flash_attention launches {need} = "
        f"{cfg.num_layers} x ({res['prefills']} prefills + "
        f"{res['decode_ticks']} ticks); the MoE dispatch ({cfg.num_experts} "
        f"experts, top {cfg.top_k}, capacity factor {cfg.capacity_factor}) "
        "is plain torch, as the reference's is plain jnp")
    return res


def encdec_phase(dev) -> dict:
    """Phase 18 (c): seamless-m4t-medium at full width and depth (bfloat16,
    kernels on): ``encode``, a prefill (which encodes again) and greedy
    ``decode_step(..., enc_out=)`` steps, each timed between syncs, with
    the launches of every kernel counted from 0 and each stage's peak
    memory (the counter reset once the weights, the inputs and the cache
    are allocated, and before each stage)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M

    cfg = configs.get_config(ENCDEC_ARCH).with_(use_kernels=True)
    b, ls, lt, steps = ENCDEC_RUN
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    g = torch.Generator(dev).manual_seed(SEED + 18)
    frames = torch.randn((b, ls, cfg.prefix_embed_dim), generator=g,
                         device=dev)
    target = torch.randint(2, cfg.vocab_size, (b, lt), generator=g,
                           device=dev, dtype=torch.int32)
    cache = M.init_cache(cfg, b, lt + steps, dev)
    # as serve_traffic: the peaks count from the weights, the inputs and
    # the cache, not init's float32 draws
    resident = torch.cuda.memory_allocated(dev)
    peaks: dict = {}
    mods = {"local_chase": lc_ops, "mailbox_pack": mp_ops,
            "flash_attention": fa_ops, "ssd_scan": ssd_ops}
    for mod in mods.values():
        mod.LAUNCHES = 0

    def timed(fn, stage):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        peaks[stage] = max(peaks.get(stage, 0),
                           torch.cuda.max_memory_allocated(dev))
        return out, (time.perf_counter() - t) * 1e3

    def greedy(logits):
        if logits.shape != (b, 1, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            fail(f"phase 18 (c): logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        return torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1).int()

    enc_out, enc_ms = timed(lambda: M.encode(
        params, {"enc_embeds": frames}, cfg), "encode")
    (lg, _), prefill_ms = timed(lambda: M.prefill(
        params, {"tokens": target, "enc_embeds": frames}, cfg, cache),
        "prefill")
    tok, step_ms, out = greedy(lg), [], []
    for i in range(steps):
        (lg, _), ms = timed(lambda: M.decode_step(
            params, tok[:, None], lt + i, cfg, cache, enc_out=enc_out),
            "decode")
        step_ms.append(ms)
        tok = greedy(lg)
        out.append(tok)
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}
    need = cfg.num_encoder_layers * 2 + 2 * cfg.num_layers * (1 + steps)
    if launches["flash_attention"] != need or any(
            n for name, n in launches.items() if name != "flash_attention"):
        fail(f"phase 18 (c): {cfg.name} launched {launches}; want "
             f"flash_attention {need} = {cfg.num_encoder_layers} x 2 encodes "
             f"+ 2 x {cfg.num_layers} x (1 prefill + {steps} steps)")
    tokens = torch.stack(out, dim=1).cpu()
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers, "d_model": cfg.d_model,
           "batch": b, "frames": ls, "target": lt, "steps": steps,
           "encode_ms": enc_ms, "prefill_ms": prefill_ms,
           "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
           "decode_tokens_per_s": b * steps / (sum(step_ms) / 1e3),
           "launches": launches,
           "resident_bytes": resident,
           "peak_memory_bytes": max(peaks.values()),
           "peak_bytes_by_stage": peaks, "sample": tokens[0, :8].tolist()}
    log(f"phase 18 (c): {cfg.name} ({cfg.num_encoder_layers} + "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{str(cfg.dtype).removeprefix('torch.')}, kernels on): encode {b} x {ls} frames {enc_ms:.2f} ms; prefill {b} x {lt} "
        f"tokens (encoding again) {prefill_ms:.2f} ms; {steps} greedy "
        f"decode steps median {res['step_ms_median']:.3f} ms (min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
        f"{res['decode_tokens_per_s']:.1f} tokens/s; peak memory "
        f"{res['peak_memory_bytes'] / 2 ** 30:.2f} GiB (resident "
        f"{resident / 2 ** 30:.2f} GiB; by stage " + ", ".join(
            f"{k} {v / 2 ** 30:.2f}" for k, v in peaks.items())
        + "); flash_attention "
        f"launches {need} = {cfg.num_encoder_layers} x 2 encodes + 2 x "
        f"{cfg.num_layers} x {1 + steps} (self and cross)")
    del params, cache, enc_out, frames
    torch.cuda.empty_cache()
    return res


def greedy_continuation(params, cfg, prompts, new: int, max_seq: int,
                        dev) -> dict:
    """{index: ``new`` tokens}: each prompt's greedy continuation by
    ``forward`` over the prompts right-padded to ``max_seq`` (causal: the
    padding changes no kept logit)."""
    import torch
    from repro_torch.models import model as M
    seqs = [list(p) for p in prompts]
    toks = np.zeros((len(prompts), max_seq), np.int32)
    for _ in range(new):
        for i, s in enumerate(seqs):
            toks[i, :len(s)] = s
        logits, _ = M.forward(params, {"tokens": torch.from_numpy(toks).to(
            dev)}, cfg)
        for i, s in enumerate(seqs):
            s.append(int(torch.argmax(logits[i, len(s) - 1,
                                             :cfg.vocab_size])))
    return {uid: s[len(p):] for uid, (p, s) in enumerate(zip(prompts, seqs))}


def moe_exactness_phase(dev) -> dict:
    """Phase 18 (d): in float32 (TF32 off) at SMOKE width, each of
    ``EXACT_ARCHS``' forward with kernels on against off, and granite-moe's
    engine tokens at capacity factor 8 against the greedy continuation of
    its own ``forward`` (the requests right-padded to one length: causal,
    and no assignment dropped, so the padding changes no kept logit)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    rng = np.random.default_rng(18)
    for arch in EXACT_ARCHS:
        cfg = configs.get_config(arch, smoke=True)
        params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
        batch = {"tokens": torch.from_numpy(rng.integers(
            2, cfg.vocab_size, (2, 96)).astype(np.int32)).to(dev)}
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.from_numpy(rng.normal(
                size=(2, 80, cfg.prefix_embed_dim)).astype(np.float32)).to(dev)
        fa_ops.LAUNCHES = 0
        on, aux_on = M.forward(params, batch, cfg.with_(use_kernels=True))
        launches = fa_ops.LAUNCHES
        off, aux_off = M.forward(params, batch, cfg)
        torch.cuda.synchronize()
        diff = max_abs_err(on, off, torch)
        need = cfg.num_layers * (2 if cfg.family == "encdec" else 1) \
            + cfg.num_encoder_layers
        res[arch] = {"max_abs_diff": diff, "launches": launches,
                     "aux_on": float(aux_on), "aux_off": float(aux_off)}
        log(f"phase 18 (d): {cfg.name} SMOKE float32 forward, kernels on "
            f"against off: max |logits diff| {diff:.3g}, aux {float(aux_on)!r}"
            f" / {float(aux_off)!r}; flash_attention launches {launches}")
        if launches != need:
            fail(f"phase 18 (d): {cfg.name}'s forward launched "
                 f"flash_attention {launches} times, not {need}")
        if not torch.allclose(on, off, atol=2e-3, rtol=1e-3) or not \
                torch.allclose(aux_on, aux_off, atol=2e-3, rtol=1e-3):
            fail(f"phase 18 (d): {cfg.name}'s forward with kernels on differs "
                 f"from off by {diff} (aux {float(aux_on)} / "
                 f"{float(aux_off)})")
        del params, on, off

    slots, max_seq, new, lengths = EXACT_SERVE
    cfg = configs.get_config(MOE_ARCH, smoke=True).with_(
        use_kernels=True, capacity_factor=8.0)
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    eng = ServingEngine(params, cfg, ServeConfig(
        slots=slots, max_seq=max_seq, max_new_tokens=new, eos_id=-1),
        device=dev)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt))
    fa_ops.LAUNCHES = 0
    got = eng.run_to_completion()
    launches = fa_ops.LAUNCHES
    want = greedy_continuation(params, cfg, prompts, new, max_seq, dev)
    res["engine"] = {"requests": len(prompts), "new_tokens": new,
                     "equal": got == want, "launches": launches}
    log(f"phase 18 (d): {cfg.name} SMOKE float32 engine, capacity factor "
        f"{cfg.capacity_factor}, {len(prompts)} requests of {list(lengths)} "
        f"tokens over {slots} slots: {new} tokens each equal to its own "
        f"forward's greedy continuation: {got == want}; flash_attention "
        f"launches {launches}")
    if got != want:
        fail(f"phase 18 (d): the engine's tokens {got} are not the greedy "
             f"continuation {want}")
    del params, eng
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------- phase 19
#: the expert-parallel layer's ("data", "model") meshes and its tokens
EP_SHAPES, EP_TOKENS = ((1, 1), (4, 1), (2, 2)), (8, 1024)
#: phase 19 (c): steps, batch, sequence length
EP_TRAIN = (3, 4, 512)
#: bfloat16 outputs whose sums run in two orders (the tensor axis's two
#: partial sums), as ``flash_attention``'s bfloat16 tolerance
EP_BF16_TOL = dict(atol=2e-2, rtol=2e-2)
EP_AXES = ("data", "model")


def _ep_layer(dev, cfg):
    """One MoE layer's weights of ``cfg`` and an input of ``EP_TOKENS``
    (random from seed ``SEED``), and the capacity factor at which no
    expert drops an assignment (the dense dispatch's, and each expert
    shard's, since the batch and the experts split over one axis)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params
    gen = torch.Generator(dev).manual_seed(SEED)
    ffn = init_params(gen, L.moe_specs(cfg))
    b, l = EP_TOKENS
    x = torch.randn((b, l, cfg.d_model), generator=gen, device=dev).to(
        cfg.dtype)
    probs = torch.softmax(x.reshape(-1, cfg.d_model).float()
                          @ ffn["router"].float(), dim=-1)
    _, idx = L._top_k(probs, cfg.top_k)
    top = int(torch.bincount(idx.reshape(-1), minlength=cfg.num_experts).max())
    return ffn, x, (top + 1.5) * cfg.num_experts / (b * l * cfg.top_k)


def _layer_ms(fn, torch):
    """(ms by CUDA events, device ms of one call under the profiler, or
    None when no window held device events twice alike)."""
    from repro_torch import devtime
    ms = time_ms(fn, torch, reps=5)
    _, events, _ = devtime.checked_window(
        lambda: devtime.window(fn, torch),
        devtime.repeat_check(lambda ev: None if ev else "no device events"),
        windows=4, log=log)
    return ms, None if events is None else devtime.device_us(events) / 1e3


def moe_ep_phase(dev) -> dict:
    """Phase 19: the mesh context and the expert-parallel MoE
    (``moe_ffn_ep``): (a) one full-width granite-moe-1b layer under virtual
    meshes against the dense dispatch, (b) the same under a ``DistMesh``
    over NCCL at world size 1, (c) ``launch/train.py`` under its (1, 1)
    mesh against the same steps without a context, (d) float32 SMOKE
    exactness. Returns the rows and the launches of (c)."""
    import math
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core.listrank import dist_mesh, sim_mesh
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import context
    from repro_torch.train import steps as train_steps
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import ATTN_TOL

    res: dict = {}
    # (a) one layer at full width, bf16, under each virtual mesh
    cfg = configs.get_config(MOE_ARCH)
    ffn, x, cf = _ep_layer(dev, cfg)
    cfg = cfg.with_(capacity_factor=cf)
    want, aux_dense = L._moe_ffn_dense(ffn, x, cfg)
    ms, dev_ms = _layer_ms(lambda: L._moe_ffn_dense(ffn, x, cfg), torch)
    rows = {"dense": {"ms": ms, "device_ms": dev_ms,
                      "aux": float(aux_dense)}}
    log(f"phase 19 (a): {cfg.name} one MoE layer at full width (d_model "
        f"{cfg.d_model}, {cfg.num_experts} experts, top {cfg.top_k}, "
        f"d_ff {cfg.d_ff}, {str(cfg.dtype).removeprefix('torch.')}), "
        f"{EP_TOKENS[0]} x {EP_TOKENS[1]} tokens, "
        f"capacity factor {cf:.4f} (no expert drops): the dense dispatch "
        f"{ms:.3f} ms, device {fmt_ms(dev_ms)}, aux {float(aux_dense):.6f}")
    outs = {}
    for shape in EP_SHAPES:
        with context.use_mesh(sim_mesh(shape, EP_AXES)) as ctx:
            tr = ctx.transport(dev)
            lc_ops.LAUNCHES = mp_ops.LAUNCHES = 0
            y, aux = L.moe_ffn(ffn, x, cfg)
            torch.cuda.synchronize()
            counts, nbytes = dict(tr.counts), dict(tr.nbytes)
            launches = {"local_chase": lc_ops.LAUNCHES,
                        "mailbox_pack": mp_ops.LAUNCHES}
            ms, dev_ms = _layer_ms(lambda: L.moe_ffn(ffn, x, cfg), torch)
        err = max_abs_err(y, want, torch)
        outs[shape] = (y, aux)
        rows[str(shape)] = {"ms": ms, "device_ms": dev_ms, "aux": float(aux),
                            "max_abs_err": err, "equal": torch.equal(y, want),
                            "collectives": counts,
                            "bytes_per_pe": nbytes, "launches": launches}
        log(f"phase 19 (a): moe_ffn_ep under a {shape} mesh: {ms:.3f} ms, "
            f"device {fmt_ms(dev_ms)}; max |y - dense| {err:.3g} "
            f"({'bit-equal' if torch.equal(y, want) else 'not bit-equal'}), "
            f"aux {float(aux):.6f}; collectives {counts}, bytes a PE "
            f"{nbytes}; launches {launches} (mailbox_pack is off on this "
            "path, as the reference's pallas_pack)")
        if not torch.allclose(y.float(), want.float(), **EP_BF16_TOL):
            fail(f"phase 19 (a): moe_ffn_ep under {shape} differs from the "
                 f"dense dispatch by {err}")
        # a hop of one PE ships nothing (exchange.route_differentiable)
        routes = {"all_to_all": 2} if shape[0] > 1 else {}
        if counts != {**routes, "psum": 2} or any(launches.values()):
            fail(f"phase 19 (a): collectives {counts}, launches {launches}")
    res["layer"] = rows

    # (b) the same layer over NCCL at world size 1
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(DIST_BACKENDS["a"],
                                init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            with context.use_mesh(dist_mesh((1, 1), EP_AXES)) as ctx:
                y_b, aux_b = L.moe_ffn(ffn, x, cfg)
                torch.cuda.synchronize()
                counts = dict(ctx.transport(dev).counts)
                acc, undo = _timed_collectives(dist, torch, dev)
                try:
                    t = time.perf_counter()
                    L.moe_ffn(ffn, x, cfg)
                    torch.cuda.synchronize()
                    wall_b = time.perf_counter() - t
                finally:
                    undo()
        finally:
            dist.destroy_process_group()
    y_a, aux_a = outs[(1, 1)]
    equal = torch.equal(y_b, y_a) and torch.equal(aux_b, aux_a)
    res["nccl"] = {"equal": equal, "collectives": counts, "wall_s": wall_b,
                   "collective_s": acc["s"], "collective_calls": acc["calls"]}
    log(f"phase 19 (b): moe_ffn_ep under a DistMesh (1, 1) over NCCL at "
        f"world size 1: bit-equal to (a)'s (1, 1): {equal}; collectives "
        f"{counts}; a call {wall_b * 1e3:.3f} ms with each collective timed "
        f"between syncs, {acc['calls']} calls {acc['s'] * 1e3:.3f} ms")
    if not equal:
        fail("phase 19 (b): the NCCL run differs from the virtual one")

    # (c) launch/train.py under its (1, 1) mesh, then without a context
    steps, batch, seq = EP_TRAIN
    cfg = configs.get_config(MOE_ARCH).with_(use_kernels=True)
    calls, real = [], L.moe_ffn_ep

    def counted(*args):
        calls.append(args[3].mesh.axis_sizes)
        return real(*args)
    L.moe_ffn_ep = counted
    try:
        row = _launcher_steps(dev, MOE_ARCH, steps, batch, seq)
    finally:
        L.moe_ffn_ep = real
    launches, peak_ep = row["launches"], row["peak_memory_bytes"]
    losses, ep_ms = row["losses"], row["step_ms"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"phase 19 (c): losses {losses}")
    # each layer's forward and its remat recompute (cfg.remat, policy
    # "nothing": the recompute runs the MoE again)
    if calls != [(1, 1)] * (2 * cfg.num_layers * steps):
        fail(f"phase 19 (c): moe_ffn_ep ran {len(calls)} times, not "
             f"2 x {cfg.num_layers} x {steps}")
    if launches["flash_attention"] != 2 * cfg.num_layers * steps:
        fail(f"phase 19 (c): launches {launches}")
    tcfg = train_steps.TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3),
                                   warmup_steps=max(steps // 10, 1),
                                   total_steps=steps)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch)
    state, _ = train_launch.initial_state(cfg, tcfg, dev)
    one_step = train_launch.step_fn(cfg, dcfg, tcfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dense_ms, dense_losses = [], []
    for step in range(steps):
        t = time.perf_counter()
        state, metrics = one_step(state, step)
        dense_losses.append(float(metrics["loss"]))  # waits for the step
        dense_ms.append((time.perf_counter() - t) * 1e3)
    peak_dense = torch.cuda.max_memory_allocated(dev)
    del state
    tokens = batch * seq
    res["train"] = {
        "steps": steps, "batch": batch, "seq": seq, "losses": losses,
        "step_ms": ep_ms, "tokens_per_s": row["tokens_per_s"],
        "peak_memory_bytes": peak_ep, "dense_losses": dense_losses, "dense_step_ms": dense_ms,
        "dense_tokens_per_s": tokens * (steps - 1) / (sum(dense_ms[1:]) / 1e3),
        "dense_peak_memory_bytes": peak_dense, "launches": launches}
    log(f"phase 19 (c): launch/train.py --arch {MOE_ARCH} (full width, "
        f"{str(cfg.dtype).removeprefix('torch.')}, "
        f"kernels on) {steps} steps of {batch} x {seq} tokens under its "
        f"(1, 1) mesh: moe_ffn_ep on all {cfg.num_layers} layers a step; "
        f"losses {', '.join(f'{v:.4f}' for v in losses)}; step ms "
        f"{', '.join(f'{v:.1f}' for v in ep_ms)} (host clock), "
        f"{res['train']['tokens_per_s']:.1f} tokens/s after the first; peak "
        f"{peak_ep / 2 ** 30:.2f} GiB (the counter reset with the weights "
        f"and optimizer state allocated, as below); launches {launches}")
    log(f"phase 19 (c): the same steps without a context (the dense "
        f"dispatch): losses {', '.join(f'{v:.4f}' for v in dense_losses)}; "
        f"step ms {', '.join(f'{v:.1f}' for v in dense_ms)}, "
        f"{res['train']['dense_tokens_per_s']:.1f} tokens/s after the first; "
        f"peak {peak_dense / 2 ** 30:.2f} GiB")
    if not math.isclose(losses[0], dense_losses[0], rel_tol=1e-2):
        fail(f"phase 19 (c): first loss {losses[0]} under the mesh, "
             f"{dense_losses[0]} without")
    torch.cuda.empty_cache()

    # (d) float32 SMOKE: kernels on against off, and repeatability
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(MOE_ARCH, smoke=True)
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    ffn = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(4, 64, cfg.d_model)).astype(
        np.float32)).to(dev)
    tokens = {"tokens": torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (4, 96)).astype(np.int32)).to(dev)}
    with context.use_mesh(sim_mesh((4, 1), EP_AXES)):
        on = L.moe_ffn(ffn, x, cfg.with_(use_kernels=True))[0]
        off = L.moe_ffn(ffn, x, cfg)[0]
        again = L.moe_ffn(ffn, x, cfg)[0]
        fa_ops.LAUNCHES = 0
        lg_on, _ = M.forward(params, tokens, cfg.with_(use_kernels=True))
        fa_launches = fa_ops.LAUNCHES
        lg_off, _ = M.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    d_model = max_abs_err(lg_on, lg_off, torch)
    res["exact"] = {"layer_on_off_equal": torch.equal(on, off),
                    "layer_repeat_equal": torch.equal(off, again),
                    "forward_max_abs_diff": d_model,
                    "flash_attention_launches": fa_launches}
    log(f"phase 19 (d): {cfg.name} SMOKE float32 under a (4, 1) mesh: "
        f"moe_ffn_ep kernels on = off bit for bit: {torch.equal(on, off)}, "
        f"equal to itself across two calls: {torch.equal(off, again)}; the "
        f"forward, kernels on against off: max |logits diff| {d_model:.3g} "
        f"(flash_attention launches {fa_launches})")
    if not (torch.equal(on, off) and torch.equal(off, again)):
        fail("phase 19 (d): moe_ffn_ep is not bit-stable")
    if fa_launches != cfg.num_layers or not torch.allclose(
            lg_on, lg_off, **ATTN_TOL[torch.float32]):
        fail(f"phase 19 (d): forward on against off {d_model}, launches "
             f"{fa_launches}")
    del params
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["remat_row"] = row  # phase 20 (c)'s remat-on row: the same steps
    return res



# --------------------------------------------------------------- phase 20
#: (a)'s list length, ranks and PEs (8 a rank); a PE of rank 1
RECOV_N, RECOV_WORLD, RECOV_P, RECOV_PE = 1 << 22, 2, 16, 12
#: seconds the parent waits for (a)'s ranks, start-up included
RECOV_TIMEOUT_S = 400
#: free space (a) needs: two directories of every boundary (about 0.4 GB
#: each at 2^22), four of three, and copies
RECOV_FREE_BYTES = 4 << 30
RECOV_LABELS = ("prep", "descend@0", "descend@1", "base@2", "ascend@1",
                "ascend@0", "post")
#: (b): examples/torch_dp_compression.py's loop: PEs, dim, rows a PE, lr,
#: steps
DPC = (8, 512, 64, 0.05, 150)
#: (b)'s final-loss gates, relative: against the exact all-reduce's loss
#: (the example's claim) and against the CPU's run of the same loop (a
#: gradient perturbed by 1e-7 relative moves the final loss by about
#: 6e-6 relative, and the card's matrix products sum in another order)
DPC_REL = 1e-4
#: (c): granite-moe-1b steps, batch, seq; hymba-1.5b steps, batch, seq
REMAT_GRANITE, REMAT_HYMBA = (3, 4, 512), (2, 2, 128)
#: (d): each arch and the ("data", "model") mesh its step runs under
REMAT_EXACT = (("mamba2-130m", None), ("hymba-1.5b", None),
               (MOE_ARCH, (4, 1)), (ENCDEC_ARCH, None))


def _recov_rank(rank: int, world: int, init: str, work: str, device: str,
                sizes: tuple, queue) -> None:
    """One process of phase 20 (a): gloo over tensors on ``device``;
    puts its result (or its traceback) on ``queue``."""
    import datetime
    import traceback
    try:
        sys.path.insert(0, str(SRC))
        import torch
        import torch.distributed as dist
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=RECOV_TIMEOUT_S))
        try:
            queue.put((rank, True, _recov_rank_work(dev, work, torch,
                                                    dist)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent fails the phase with this traceback
        queue.put((rank, False, traceback.format_exc()))


def _recov_rank_work(dev, work: str, torch, dist) -> dict:
    """Phase 20 (a)'s cases on one rank; each case's wall, launches,
    output digest, counters, stage log and recovery record."""
    import shutil
    from repro_torch.core.listrank import (FaultSpec, ListRankConfig,
                                           dist_mesh, rank_list_with_stats)
    from repro_torch.runtime.fault_tolerance import (Preempted,
                                                     SolveSupervisor,
                                                     SolveSupervisorConfig)
    ops = kernel_ops()
    work = pathlib.Path(work)
    succ = np.load(work / "succ.npy")
    rank_in = np.load(work / "rank.npy")
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    mesh = dist_mesh(RECOV_P)
    me = dist.get_rank()
    out = {"pes": [me * mesh.pes_per_rank, (me + 1) * mesh.pes_per_rank - 1],
           "cases": {}}

    def solve(case, directory=None, inject=None, keep=3):
        sup = (SolveSupervisor(SolveSupervisorConfig(
            ckpt_dir=str(work / directory), keep=keep))
            if directory else None)
        dist.barrier()
        for mod in ops.values():
            mod.LAUNCHES = 0
        _synchronize(torch, dev)
        t = time.perf_counter()
        row = {}
        try:
            s, r, st = rank_list_with_stats(succ, rank_in, mesh, cfg=cfg,
                                            seed=SEED, device=dev,
                                            supervisor=sup, inject=inject)
        except Preempted:
            _synchronize(torch, dev)
            row["preempted_at"] = sup.ckpt.latest_step()
        else:
            _synchronize(torch, dev)
            row.update(digest=_digest(s.cpu().numpy(), r.cpu().numpy()),
                       counters=int_counters(st),
                       stage_log=list(st["stage_log"]),
                       stages_s=sum(dt for _, dt in st["stage_wall_s"]),
                       recovery={k: (list(v) if isinstance(v, tuple) else v)
                                 for k, v in st["recovery"].items()})
        row["wall_s"] = time.perf_counter() - t
        row["launches"] = {name: mod.LAUNCHES for name, mod in ops.items()}
        if sup is not None:
            row["records"] = {str(k): v for k, v in
                              sup.ckpt.records.items()}
            row["restore"] = sup.ckpt.last_restore
        out["cases"][case] = row

    solve("plain_cold")
    solve("plain")
    solve("a", "dist", keep=len(RECOV_LABELS) - 1)
    solve("b_preempted", "pre", inject=[FaultSpec(
        "preempt", stage="descend", level=0)] if me == 1 else None)
    if me == 0:  # for the virtual transport to resume, in the parent
        shutil.copytree(work / "pre", work / "pre_for_virtual")
    solve("b", "pre")
    solve("c", "loss", inject=FaultSpec("pe_loss", stage="base",
                                        pe=RECOV_PE))
    solve("d", "corrupt", inject=FaultSpec("corrupt", stage="descend",
                                           level=0, pe=RECOV_PE))
    solve("e", "virtual_pre")
    return out


def _same_checkpoints(a: pathlib.Path, b: pathlib.Path) -> list:
    """The step directories of ``a``, each checked equal to ``b``'s in
    keys, manifest meta and every array's bytes."""
    steps = sorted(d.name for d in a.glob("step_*"))
    if steps != sorted(d.name for d in b.glob("step_*")):
        fail(f"phase 20 (a): step directories {steps} against "
             f"{sorted(d.name for d in b.glob('step_*'))}")
    for step in steps:
        ma = json.loads((a / step / "manifest.json").read_text())
        mb = json.loads((b / step / "manifest.json").read_text())
        if ma["keys"] != mb["keys"] or ma["meta"] != mb["meta"]:
            fail(f"phase 20 (a): {step}'s manifest differs")
        with np.load(a / step / "state.npz") as x, \
                np.load(b / step / "state.npz") as y:
            for k in x.files:
                if x[k].dtype != y[k].dtype or x[k].tobytes() != \
                        y[k].tobytes():
                    fail(f"phase 20 (a): {step} {k} differs")
    return steps


def _recovery_dist(dev, card: str, n: int) -> dict:
    """Phase 20 (a)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core.listrank import (FaultSpec, ListRankConfig,
                                           instances, rank_list_seq,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch.runtime.fault_tolerance import (Preempted,
                                                     SolveSupervisor,
                                                     SolveSupervisorConfig)
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    succ, rank = instances.gen_list(n, gamma=1.0, seed=1)
    s_ref, r_ref = rank_list_seq(succ, rank)
    mesh = sim_mesh(RECOV_P)
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_recovery_dist_"))
    res: dict = {"n": n, "p": RECOV_P, "world": RECOV_WORLD}
    try:
        free = shutil.disk_usage(root).free
        if free < RECOV_FREE_BYTES:
            fail(f"phase 20 (a): {free} bytes free under {root}, "
                 f"{RECOV_FREE_BYTES} needed")

        def virtual(directory=None, inject=None, keep=3):
            sup = (SolveSupervisor(SolveSupervisorConfig(
                ckpt_dir=str(root / directory), keep=keep))
                if directory else None)
            _synchronize(torch, dev)
            t = time.perf_counter()
            s, r, st = rank_list_with_stats(succ, rank, mesh, cfg=cfg,
                                            seed=SEED, device=dev,
                                            supervisor=sup, inject=inject)
            _synchronize(torch, dev)
            return s, r, st, time.perf_counter() - t

        s, r, st, wall = virtual()
        if not (np.array_equal(s.cpu().numpy(), s_ref)
                and r.cpu().numpy().tobytes() == r_ref.tobytes()):
            fail("phase 20 (a): the virtual solve differs from the oracle")
        digest = _digest(s.cpu().numpy(), r.cpu().numpy())
        ints = int_counters(st)
        res["virtual_s"] = wall
        *_, res["virtual_supervised_s"] = virtual(
            "virtual", keep=len(RECOV_LABELS) - 1)
        try:
            virtual("virtual_pre", FaultSpec("preempt", stage="descend",
                                             level=0))
            fail("phase 20 (a): the virtual solve was not preempted")
        except Preempted:
            pass
        np.save(root / "succ.npy", succ)
        np.save(root / "rank.npy", rank)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        outs = _run_ranks(RECOV_WORLD, root, str(dev), (), RECOV_TIMEOUT_S,
                          target=_recov_rank, phase="20 (a)")
        res["ranks_s"] = time.perf_counter() - t

        interior = RECOV_LABELS[:-1]
        for rk, out in enumerate(outs):
            cases = out["cases"]
            for name, row in cases.items():
                if name == "b_preempted":
                    if row["preempted_at"] != 2:
                        fail(f"phase 20 (a): rank {rk} stopped at "
                             f"{row['preempted_at']}, not 2")
                    continue
                if row["digest"] != digest or row["counters"] != ints:
                    fail(f"phase 20 (a) ({name}): rank {rk}'s outputs or "
                         f"counters differ from the virtual solve's")
                log_ = row["stage_log"]
                preps = executed(log_, "prep")
                others = sum(executed(log_, k) for k in
                             ("descend", "base", "ascend", "post"))
                lm = row["launches"]["flash_attention"] + row[
                    "launches"]["ssd_scan"]
                if row["launches"]["local_chase"] != preps or \
                        row["launches"]["mailbox_pack"] < others or lm:
                    fail(f"phase 20 (a) ({name}): rank {rk} launched "
                         f"{row['launches']} for {log_}")
            rec = {k: cases[k]["recovery"] for k in "abcde"}
            if cases["a"]["stage_log"] != list(RECOV_LABELS) or \
                    rec["a"]["checkpoints"] != len(interior):
                fail(f"phase 20 (a) (a): rank {rk}: {rec['a']}")
            for case, frm, log_ in (
                    ("b", 2, list(RECOV_LABELS[2:])),
                    ("e", 2, list(RECOV_LABELS[2:]))):
                if rec[case]["resumed_from"] != frm or \
                        cases[case]["stage_log"] != log_:
                    fail(f"phase 20 (a) ({case}): rank {rk}: {rec[case]}, "
                         f"{cases[case]['stage_log']}")
            c_log, d_log = cases["c"]["stage_log"], cases["d"]["stage_log"]
            if rec["c"]["resumed_from"] != 3 or c_log.count(
                    "base@2!InjectedFault") != 1 or c_log.count(
                    "descend@0") != 1:
                fail(f"phase 20 (a) (c): rank {rk}: {rec['c']}, {c_log}")
            if rec["d"]["resumed_from"] != 1 or d_log.count(
                    "descend@0!CorruptedState") != 1 or d_log.count(
                    "prep") != 1:
                fail(f"phase 20 (a) (d): rank {rk}: {rec['d']}, {d_log}")
        res["steps_compared"] = _same_checkpoints(root / "dist",
                                                  root / "virtual")
        # the reverse: the virtual transport resumes the ranks' checkpoint
        s, r, st, res["virtual_resume_s"] = virtual("pre_for_virtual")
        if _digest(s.cpu().numpy(), r.cpu().numpy()) != digest or \
                st["recovery"]["resumed_from"] != 2:
            fail(f"phase 20 (a): the virtual transport's resume of the "
                 f"ranks' checkpoint: {st['recovery']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["ranks"] = outs
    res["launches"] = outs[0]["cases"]["a"]["launches"]
    a0 = outs[0]["cases"]["a"]
    res["checkpoints"] = {f"{k} ({RECOV_LABELS[int(k) - 1]})": v
                          for k, v in sorted(a0["records"].items(),
                                             key=lambda kv: int(kv[0]))}
    log(f"phase 20 (a): List({n}, gamma=1), p={RECOV_P} over "
        f"{RECOV_WORLD} gloo ranks on the card, kernels on; the virtual "
        f"transport's solve: {res['virtual_s']:.3f} s, then supervised "
        f"{res['virtual_supervised_s']:.3f} s; every case on every rank "
        f"equal to it (outputs and counters); boundary checkpoints "
        f"{res['steps_compared']} equal byte for byte; the virtual "
        f"transport resumed the ranks' preempted checkpoint in "
        f"{res['virtual_resume_s']:.3f} s; the ranks took "
        f"{res['ranks_s']:.1f} s with start-up [{card}]")
    for name, rec in res["checkpoints"].items():
        log(f"phase 20 (a): boundary {name}: {rec['bytes']} bytes, snapshot "
            f"(device to host, rank 0) {rec['snapshot_s']:.3f} s, write "
            f"{rec['write_s']:.3f} s [{card}]")
    for rk, out in enumerate(outs):
        c = out["cases"]
        log(f"phase 20 (a): rank {rk} (PEs {out['pes'][0]}..{out['pes'][1]}"
            f"): unsupervised cold {c['plain_cold']['wall_s']:.3f} s, warm "
            f"{c['plain']['wall_s']:.3f} s; supervised "
            f"{c['a']['wall_s']:.3f} s; preempted on rank 1 "
            f"{c['b_preempted']['wall_s']:.3f} s, resumed "
            f"{c['b']['wall_s']:.3f} s; PE {RECOV_PE} lost "
            f"{c['c']['wall_s']:.3f} s; corrupted {c['d']['wall_s']:.3f} s; "
            f"the virtual checkpoint resumed {c['e']['wall_s']:.3f} s; "
            f"launches supervised {c['a']['launches']} [{card}]")
    return res


def _state_bytes(tree) -> int:
    from repro_torch.checkpoint.checkpointer import flatten
    return sum(x.numel() * x.element_size() for x in flatten(tree)[1])


def _int8_runtime(dev, card: str) -> dict:
    """Phase 20 (b)."""
    import math
    import torch
    from repro_torch import configs
    from repro_torch.core.listrank import sim_mesh
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_launch
    from repro_torch.optim import adamw
    from repro_torch.core.listrank import transport as tl
    from repro_torch.runtime import compression
    from repro_torch.train import steps as train_steps
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {}
    # compressed_psum on the card against the CPU on the same inputs
    rng = np.random.default_rng(20)
    p, dim = DPC[0], DPC[1]
    x = rng.normal(size=(p, 3, dim)).astype(np.float32)
    x[2] = 0.0
    e = (rng.normal(size=(p, 3, dim)) * 1e-3).astype(np.float32)
    outs = {}
    for where in ("cpu", str(dev)):
        tr = tl.VirtualTransport(("data",), (p,), torch.device(where))
        red, new = compression.compressed_psum(
            torch.from_numpy(x).to(where), tr, torch.from_numpy(e).to(where))
        outs[where] = (red.cpu().numpy(), new.cpu().numpy())
    bits = outs["cpu"][1].tobytes() == outs[str(dev)][1].tobytes()
    sum_rel = float(np.abs(outs["cpu"][0] - outs[str(dev)][0]).max()
                    / np.abs(outs["cpu"][0]).max())
    if not bits or sum_rel > 1e-6:
        fail(f"phase 20 (b): compressed_psum on the card: new error "
             f"bit-equal {bits}, sum {sum_rel:.3g} relative from the CPU's")
    dp_losses = load_example("torch_dp_compression").dp_losses
    t = time.perf_counter()
    comp = dp_losses(dev, True, *DPC)
    res["dp_s"] = time.perf_counter() - t
    exact = dp_losses(dev, False, *DPC)
    cpu = dp_losses("cpu", True, *DPC)
    rel_exact = abs(comp[-1] - exact[-1]) / exact[-1]
    rel_cpu = abs(comp[-1] - cpu[-1]) / cpu[-1]
    res["dp"] = {"final_loss": comp[-1], "exact_final_loss": exact[-1],
                 "cpu_final_loss": cpu[-1], "rel_exact": rel_exact,
                 "rel_cpu": rel_cpu, "first_loss": comp[0],
                 "new_error_bit_equal": bits, "sum_rel_cpu": sum_rel}
    log(f"phase 20 (b): compressed_psum on the card, {p} PEs x 3 x {dim}: "
        f"new error bit-equal to the CPU's, the sum {sum_rel:.3g} relative "
        f"from it; examples/torch_dp_compression.py's loop ({DPC[4]} steps, "
        f"{res['dp_s']:.2f} s): loss {comp[0]:.6g} -> {comp[-1]:.9g}, the "
        f"exact all-reduce's {exact[-1]:.9g} ({rel_exact:.3g} relative), "
        f"the CPU's {cpu[-1]:.9g} ({rel_cpu:.3g} relative) [{card}]")
    if not (math.isfinite(comp[-1]) and comp[-1] < comp[0]
            and rel_exact <= DPC_REL and rel_cpu <= DPC_REL):
        fail(f"phase 20 (b): the compressed loop's loss {comp[-1]}, exact "
             f"{exact[-1]}, CPU {cpu[-1]}")

    # one granite-moe-1b step at full width with int8 AdamW state
    cfg = configs.get_config(MOE_ARCH).with_(use_kernels=True)
    tcfg = train_steps.TrainConfig(optimizer=adamw.AdamWConfig(
        lr=3e-3, state_dtype="int8"), warmup_steps=1, total_steps=1)
    steps, batch, seq = REMAT_GRANITE
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch)
    state, _ = train_launch.initial_state(cfg, tcfg, dev)
    params, opt = state
    f32 = _state_bytes(adamw.init(
        train_launch.state_like(cfg, train_steps.TrainConfig())[0],
        adamw.AdamWConfig()))
    int8 = _state_bytes(opt)
    one = train_launch.step_fn(cfg, dcfg, tcfg, dev,
                               mesh=sim_mesh((1, 1), ("data", "model")))
    t = time.perf_counter()
    state, metrics = one(state, 0)
    loss = float(metrics["loss"])
    wall = time.perf_counter() - t
    if not math.isfinite(loss):
        fail(f"phase 20 (b): granite's int8-state step: loss {loss}")
    res["granite_int8"] = {"loss": loss, "step_s": wall,
                           "state_bytes_int8": int8,
                           "state_bytes_float32": f32}
    log(f"phase 20 (b): {cfg.name} one step at full width with int8 AdamW "
        f"state ({batch} x {seq} tokens, remat on): loss {loss:.4f}, "
        f"{wall * 1e3:.1f} ms (the first step); optimizer state "
        f"{int8 / 2 ** 30:.2f} GiB against {f32 / 2 ** 30:.2f} GiB with "
        f"float32 moments (both with the float32 master copy) [{card}]")
    del state, params, opt, one
    torch.cuda.empty_cache()
    return res


def _launcher_steps(dev, arch: str, steps_n: int, batch: int, seq: int,
                    cfg_fn=None, tcfg=None) -> dict:
    """``steps_n`` steps of ``arch`` at full width through
    ``launch/train.py`` (``main`` when ``tcfg`` is None; else its
    ``initial_state`` and ``step_fn`` with ``tcfg``), under its (1, 1)
    mesh, kernels on, ``cfg_fn`` applied to the config; the peak-memory
    counter reset once the weights and the optimizer state exist. Its
    losses, ms a step (host clock, each step ended by reading its loss),
    peak memory and LM-kernel launches."""
    import torch
    from repro_torch import configs
    from repro_torch.core.listrank import sim_mesh
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import train as train_launch
    mods = {"flash_attention": fa_ops, "local_chase": lc_ops,
            "mailbox_pack": mp_ops, "ssd_scan": ssd_ops}
    real_get, real_init = configs.get_config, train_launch.initial_state

    def get_config(name, smoke=False):
        cfg = real_get(name, smoke=smoke)
        return cfg_fn(cfg) if cfg_fn is not None else cfg

    def initial_state(*a, **kw):
        out = real_init(*a, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return out
    for mod in mods.values():
        mod.LAUNCHES = 0
    train_launch.configs.get_config = get_config
    train_launch.initial_state = initial_state
    try:
        if tcfg is None:
            history = train_launch.main([
                "--arch", arch, "--use-kernels", "--batch", str(batch),
                "--seq", str(seq), "--steps", str(steps_n), "--log-every",
                "1", "--device", str(dev)])
            losses = [h["loss"] for h in history]
            ms = [h["ms"] for h in history]
        else:
            cfg = get_config(arch).with_(use_kernels=True)
            dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=batch)
            state, _ = train_launch.initial_state(cfg, tcfg, dev)
            one = train_launch.step_fn(cfg, dcfg, tcfg, dev, mesh=sim_mesh(
                (1, 1), ("data", "model")))
            losses, ms = [], []
            for step in range(steps_n):
                t = time.perf_counter()
                state, metrics = one(state, step)
                losses.append(float(metrics["loss"]))
                ms.append((time.perf_counter() - t) * 1e3)
            del state, one
    finally:
        train_launch.configs.get_config = real_get
        train_launch.initial_state = real_init
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: mod.LAUNCHES for k, mod in mods.items()}
    torch.cuda.empty_cache()
    tokens = batch * seq
    warm = ms[1:] or ms
    return {"losses": losses, "step_ms": ms, "peak_memory_bytes": peak,
            "tokens_per_s": tokens * len(warm) / (sum(warm) / 1e3),
            "launches": launches, "steps": steps_n, "batch": batch,
            "seq": seq}


def _grad_peak(dev, cfg, batch: int, seq: int) -> int:
    """The peak memory of one forward and backward (``value_and_grad``)
    of ``cfg`` under a (1, 1) mesh, the counter reset once the weights
    exist: what the activations (or remat's recompute) add."""
    import torch
    from repro_torch.core.listrank import sim_mesh
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    from repro_torch.runtime import context
    from repro_torch.train import steps as train_steps
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    data = pipeline.device_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch), 0, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with context.use_mesh(sim_mesh((1, 1), ("data", "model"))):
        out = train_steps.value_and_grad(params, data, cfg,
                                         train_steps.TrainConfig())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del params, out
    torch.cuda.empty_cache()
    return peak


def _remat_full_width(dev, card: str, granite_remat=None) -> dict:
    """Phase 20 (c). ``granite_remat``: phase 19 (c)'s row, the same
    granite-moe-1b steps through ``launch/train.py`` with remat on (run
    here when None)."""
    from repro_torch import configs
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    res: dict = {}
    steps_n, batch, seq = REMAT_GRANITE
    granite = configs.get_config(MOE_ARCH).with_(use_kernels=True)
    layers = granite.num_layers
    res["granite_grad_peak"] = {
        "remat": _grad_peak(dev, granite, batch, seq),
        "no_remat": _grad_peak(dev, granite.with_(remat=False), batch, seq)}
    log(f"phase 20 (c): {MOE_ARCH} one forward and backward of {batch} x "
        f"{seq} tokens under its (1, 1) mesh: peak above the weights "
        f"{res['granite_grad_peak']['remat'] / 2 ** 30:.2f} GiB with remat, "
        f"{res['granite_grad_peak']['no_remat'] / 2 ** 30:.2f} GiB without "
        f"[{card}]")
    for name, fn in (("granite_remat", None),
                     ("granite_no_remat", lambda c: c.with_(remat=False))):
        if fn is None and granite_remat is not None:
            row = granite_remat
        else:
            row = _launcher_steps(dev, MOE_ARCH, steps_n, batch, seq, fn)
        per = 2 if fn is None else 1  # the remat recompute launches again
        if not all(np.isfinite(row["losses"])) or \
                row["launches"]["flash_attention"] != per * layers * steps_n:
            fail(f"phase 20 (c) {name}: losses {row['losses']}, launches "
                 f"{row['launches']}")
        res[name] = row
        log(f"phase 20 (c): {MOE_ARCH} via launch/train.py, {steps_n} steps "
            f"of {batch} x {seq} tokens under its (1, 1) mesh, "
            f"{'remat on' if fn is None else 'remat off'}"
            f"{' (phase 19 (c), reused)' if row is granite_remat else ''}: "
            f"losses "
            f"{', '.join(f'{v:.4f}' for v in row['losses'])}; step ms "
            f"{', '.join(f'{v:.1f}' for v in row['step_ms'])}, "
            f"{row['tokens_per_s']:.1f} tokens/s after the first; peak "
            f"{row['peak_memory_bytes'] / 2 ** 30:.2f} GiB (the counter "
            f"reset with the weights and optimizer state allocated); "
            f"launches {row['launches']} [{card}]")
    steps_n, batch, seq = REMAT_HYMBA
    hy = configs.get_config("hymba-1.5b")
    tcfg = train_steps.TrainConfig(optimizer=adamw.AdamWConfig(
        lr=3e-3, state_dtype="int8"), warmup_steps=1, total_steps=steps_n)
    row = _launcher_steps(dev, "hymba-1.5b", steps_n, batch, seq, tcfg=tcfg)
    want = 2 * hy.num_layers * steps_n
    if not all(np.isfinite(row["losses"])) or \
            row["launches"]["flash_attention"] != want or \
            row["launches"]["ssd_scan"] != want:
        fail(f"phase 20 (c) hymba: losses {row['losses']}, launches "
             f"{row['launches']}")
    res["hymba"] = row
    log(f"phase 20 (c): hymba-1.5b at full width ({hy.num_layers} layers, "
        f"d_model {hy.d_model}, bf16, kernels on, remat, int8 AdamW "
        f"state), {steps_n} steps of {batch} x {seq} tokens: losses "
        f"{', '.join(f'{v:.4f}' for v in row['losses'])}; step ms "
        f"{', '.join(f'{v:.1f}' for v in row['step_ms'])}; peak "
        f"{row['peak_memory_bytes'] / 2 ** 30:.2f} GiB (the counter reset "
        f"with the weights and optimizer state allocated); launches "
        f"{row['launches']} [{card}]")
    return res


def _remat_exactness(dev) -> dict:
    """Phase 20 (d): each model's step twice without remat (it must
    repeat bit for bit) and once with, equal to it bit for bit."""
    import warnings
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic kernels where torch has them (an embedding's backward
    # accumulates with atomics otherwise): a step must repeat bit for bit
    # before remat's recompute can be held to the forward's bits
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return _remat_steps_equal(dev)
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])


def _remat_steps_equal(dev) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.core.listrank import sim_mesh
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    from repro_torch.runtime import context
    from repro_torch.train import steps as train_steps
    res = {}
    for arch, mesh in REMAT_EXACT:
        base = configs.get_config(arch, smoke=True).with_(
            dtype=torch.float32, use_kernels=True)
        params = M.init(base, torch.Generator(dev).manual_seed(SEED), dev)
        batch = pipeline.device_batch(pipeline.DataConfig(
            vocab_size=base.vocab_size, seq_len=64, global_batch=4), 0, dev)
        if base.family == "encdec":
            batch["enc_embeds"] = torch.randn(
                (4, 64, base.prefix_embed_dim), device=dev,
                generator=torch.Generator(dev).manual_seed(SEED))
        got = []
        for remat in (True, False, False):
            cfg = base.with_(remat=remat)
            with (context.use_mesh(sim_mesh(mesh, ("data", "model")))
                  if mesh else contextlib.nullcontext()):
                (loss, _), grads = train_steps.value_and_grad(
                    params, batch, cfg, train_steps.TrainConfig())
            got.append((loss, leaves(grads)))

        def same(x, y):
            return torch.equal(x[0], y[0]) and all(
                torch.equal(a, b) for a, b in zip(x[1], y[1]))
        repeat, equal = same(got[1], got[2]), same(got[0], got[1])
        res[arch] = {"equal": equal, "no_remat_repeats": repeat,
                     "loss": float(got[0][0]), "leaves": len(got[0][1])}
        if not (repeat and equal):
            diff = max(max_abs_err(a, b, torch)
                       for a, b in zip(got[0][1], got[1][1]))
            fail(f"phase 20 (d): {arch}: the step without remat repeats "
                 f"bit for bit: {repeat}; remat on against off: losses "
                 f"{float(got[0][0])} / {float(got[1][0])}, gradients "
                 f"{diff}")
        del params, got
        torch.cuda.empty_cache()
    log(f"phase 20 (d): float32 SMOKE, kernels on, deterministic torch "
        f"kernels, one step each: the loss and every gradient bit-equal "
        f"with remat on and off, and without remat twice, for "
        + ", ".join(a + (f" under {m}" if m else "")
                    for a, m in REMAT_EXACT))
    return res


def recovery_dist_phase(dev, card: str = "", n: int = RECOV_N,
                        granite_remat=None) -> dict:
    """Phase 20: (a) supervised and fault-injected solves over 2 gloo
    ranks on the card against the virtual transport, (b) the int8
    runtime, (c) remat at full width (``granite_remat``: phase 19 (c)'s
    row, when it ran), (d) recompute determinism. Returns the rows, (a)'s
    launches per rank and (c)'s launches per model."""
    t0 = time.perf_counter()
    res = _recovery_dist(dev, card, n)
    res["a_s"] = time.perf_counter() - t0
    res["int8"] = _int8_runtime(dev, card)
    res["b_s"] = time.perf_counter() - t0 - res["a_s"]
    rows = _remat_full_width(dev, card, granite_remat)
    res["remat"] = {MOE_ARCH: rows["granite_remat"],
                    "hymba-1.5b": rows["hymba"]}
    res["no_remat"] = {MOE_ARCH: rows["granite_no_remat"]}
    res["grad_peak"] = rows["granite_grad_peak"]
    res["c_s"] = time.perf_counter() - t0 - res["a_s"] - res["b_s"]
    res["exact"] = _remat_exactness(dev)
    d_s = time.perf_counter() - t0 - res["a_s"] - res["b_s"] - res["c_s"]
    log(f"phase 20: (a) {res['a_s']:.1f} s, (b) {res['b_s']:.1f} s, (c) "
        f"{res['c_s']:.1f} s, (d) {d_s:.1f} s")
    return res


# --------------------------------------------------------------- phase 21
#: (b): tinyllama-1.1b's prefill on the card: batch, length (the cache's too)
DRY_PREFILL = (8, 1024)
#: (c): examples/torch_trace_solve.py's list length and PEs
DRY_TRACE = (1 << 16, 8)
#: relative gates: (a) the step's peak, (a) the forward and backward's
#: peak above the weights, (b) the prefill's peak
DRY_STEP_REL, DRY_GRAD_REL, DRY_PREFILL_REL = 0.10, 0.25, 0.15
DRY_TRACE_OUT = OBS_TRACE.parent / "chip_smoke_trace_solve.json"


def _launcher_tcfg(steps_n: int):
    """The ``TrainConfig`` ``launch/train.py`` builds for ``steps_n``
    steps at its default learning rate (phase 20 (c)'s rows)."""
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    return train_steps.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=3e-3),
        warmup_steps=max(steps_n // 10, 1), total_steps=steps_n)


def _no_card_work(dev, fn):
    """``fn()`` with the card's allocated bytes and every kernel's launch
    count read before and after: the dry run must change neither."""
    import torch
    mods = kernel_ops()
    before = ({k: m.LAUNCHES for k, m in mods.items()},
              torch.cuda.memory_allocated(dev))
    out = fn()
    after = ({k: m.LAUNCHES for k, m in mods.items()},
             torch.cuda.memory_allocated(dev))
    if after != before:
        fail(f"phase 21: the dry run touched the card: launches and bytes "
             f"{before} -> {after}")
    return out


def _dry_granite(dev, card: str, rows: dict, grad_peaks: dict) -> dict:
    """(a): the dry run of granite-moe-1b's launcher step at (1, 1)
    against phase 20 (c)'s measured rows."""
    from repro_torch.core.listrank import sim_mesh
    from repro_torch.launch import dryrun
    steps_n, batch, seq = REMAT_GRANITE
    one = sim_mesh((1, 1), ("data", "model"))
    res = {}
    for name, remat in (("remat", True), ("no_remat", False)):
        t = time.perf_counter()
        with dryrun.patched_shape("train_4k", seq, batch):
            rec, _ = _no_card_work(dev, lambda: dryrun.lower_cell(
                MOE_ARCH, "train_4k", remat=remat, mesh=one,
                use_kernels=True, tcfg=_launcher_tcfg(steps_n)))
        mem = rec["memory"]
        peak, fb = mem["peak_bytes_per_device"], \
            mem["forward_backward_bytes_per_device"]
        got_peak = rows[name]["peak_memory_bytes"]
        got_fb = grad_peaks[name]
        rel_peak, rel_fb = peak / got_peak - 1, fb / got_fb - 1
        res[name] = {"predicted_peak_bytes": peak,
                     "measured_peak_bytes": got_peak,
                     "predicted_forward_backward_bytes": fb,
                     "measured_forward_backward_bytes": got_fb,
                     "rel_peak": rel_peak, "rel_forward_backward": rel_fb,
                     "update_bytes": mem["update_bytes_per_device"],
                     "argument_bytes": mem["argument_bytes_per_device"],
                     "flops": rec["cost"]["flops_per_device"],
                     "collectives": rec["collectives"]["counts"],
                     "trace_s": time.perf_counter() - t}
        log(f"phase 21 (a): dry run of {MOE_ARCH} at (1, 1), {batch} x {seq} "
            f"tokens, {name.replace('_', ' ')}, kernels' path, launch/"
            f"train.py's TrainConfig ({res[name]['trace_s']:.1f} s on the "
            f"host): step peak {peak / 2 ** 30:.2f} GiB predicted against "
            f"{got_peak / 2 ** 30:.2f} measured ({rel_peak:+.1%}); forward "
            f"and backward above the weights {fb / 2 ** 30:.2f} against "
            f"{got_fb / 2 ** 30:.2f} GiB ({rel_fb:+.1%}); the update "
            f"{mem['update_bytes_per_device'] / 2 ** 30:.2f} GiB above the "
            f"inputs; {rec['cost']['flops_per_device']:.4g} FLOPs; "
            f"collectives {rec['collectives']['counts']} [{card}]")
        if abs(rel_peak) > DRY_STEP_REL or abs(rel_fb) > DRY_GRAD_REL:
            fail(f"phase 21 (a) {name}: predicted {peak} / {fb} bytes, "
                 f"measured {got_peak} / {got_fb}")
    return res


def _dry_prefill(dev, card: str) -> dict:
    """(b): tinyllama-1.1b's prefill with its cache: the dry run at (1, 1)
    against the real call on the card."""
    import torch
    from repro_torch import configs
    from repro_torch.core.listrank import sim_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    batch, seq = DRY_PREFILL
    one = sim_mesh((1, 1), ("data", "model"))
    t = time.perf_counter()
    with dryrun.patched_shape("prefill_32k", seq, batch):
        rec, _ = _no_card_work(dev, lambda: dryrun.lower_cell(
            SERVE_ARCH, "prefill_32k", mesh=one))
    dry_s = time.perf_counter() - t
    mem = rec["memory"]
    # the real call, at the dry run's config (no kernels)
    cfg = configs.get_config(SERVE_ARCH).with_(use_kernels=False)
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=dev,
                           dtype=torch.int32,
                           generator=torch.Generator(dev).manual_seed(SEED))
    cache = M.init_cache(cfg, batch, seq, dev)
    inputs = leaves(params) + [tokens] + list(cache)
    read = sum(x.numel() * x.element_size() for x in inputs)
    if mem["pruned_inputs"] or mem["argument_bytes_per_device"] != read:
        fail(f"phase 21 (b): argument bytes {mem['argument_bytes_per_device']}"
             f" (pruned {mem['pruned_inputs']}), the call reads {read}")
    walls, peaks = [], []
    with torch.no_grad():
        for _ in range(3):  # the first carries cuBLAS's set-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t = time.perf_counter()
            logits, cache = M.prefill(params, {"tokens": tokens}, cfg, cache)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            peaks.append(torch.cuda.max_memory_allocated(dev) - base + read)
            del logits
    measured = peaks[-1]
    if not bool(torch.isfinite(cache.k).all()):
        fail("phase 21 (b): the prefill wrote a non-finite cache")
    predicted = mem["peak_bytes_per_device"]
    rel = predicted / measured - 1
    bound = rec["roofline"]["step_time_bound_s"]
    res = {"argument_bytes": read, "predicted_peak_bytes": predicted,
           "measured_peak_bytes": measured, "peaks": peaks, "rel_peak": rel,
           "walls_s": walls, "step_time_bound_s": bound,
           "bottleneck": rec["roofline"]["bottleneck"],
           "flops": rec["cost"]["flops_per_device"], "dry_s": dry_s}
    log(f"phase 21 (b): {SERVE_ARCH} prefill of {batch} x {seq} tokens into "
        f"its cache, no kernels: argument bytes {read} = the tensors the call "
        f"reads (dry run {dry_s:.1f} s on the host); peak "
        f"{predicted / 2 ** 30:.3f} GiB predicted against "
        f"{measured / 2 ** 30:.3f} measured ({rel:+.1%}; the counter reset "
        f"with the inputs allocated); wall "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms against the "
        f"roofline's {bound * 1e3:.2f} ms bound "
        f"({rec['roofline']['bottleneck']}) [{card}]")
    del params, tokens, cache, inputs
    torch.cuda.empty_cache()
    if abs(rel) > DRY_PREFILL_REL:
        fail(f"phase 21 (b): predicted peak {predicted}, measured {measured}")
    return res


def _trace_solve(dev, card: str) -> dict:
    """(c): ``examples/torch_trace_solve.py`` on the card."""
    import io
    mods = kernel_ops()
    for m in mods.values():
        m.LAUNCHES = 0
    example = load_example("torch_trace_solve")
    n, p = DRY_TRACE
    DRY_TRACE_OUT.parent.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = example.main([str(DRY_TRACE_OUT), "--n", str(n), "--p",
                                str(p), "--device", str(dev)])
    except AssertionError as e:
        fail(f"phase 21 (c): trace_solve differs from the oracle: {e}")
    wall = time.perf_counter() - t
    text = buf.getvalue()
    trace = json.loads(DRY_TRACE_OUT.read_text())
    spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    if "matches the oracle" not in text or not spans:
        fail(f"phase 21 (c): trace_solve printed {text[:200]!r}, {spans} "
             f"spans")
    DRY_TRACE_OUT.with_suffix(".txt").write_text(text)
    log(f"phase 21 (c): {text.splitlines()[0]} (its tables in "
        f"{DRY_TRACE_OUT.with_suffix('.txt').name})")
    log(f"phase 21 (c): examples/torch_trace_solve.py n={n} p={p} on the "
        f"card: matches the oracle, {out['stats']['attempts']} attempt(s), "
        f"{spans} spans in {DRY_TRACE_OUT.name}, {wall:.2f} s with its tables; "
        f"launches {launches} [{card}]")
    return {"wall_s": wall, "spans": spans, "launches": launches,
            "attempts": out["stats"]["attempts"]}


def dryrun_phase(dev, card: str = "", rows=None, grad_peaks=None) -> dict:
    """Phase 21: (a) the dry run of granite-moe-1b's training step at (1,
    1) against the measured step and forward-and-backward peaks (``rows``:
    phase 20 (c)'s granite rows ``{"remat", "no_remat"}``, ``grad_peaks``
    its ``_grad_peak`` values; both measured here when None), (b)
    tinyllama-1.1b's prefill against the real call, (c)
    ``examples/torch_trace_solve.py`` on the card."""
    t0 = time.perf_counter()
    if rows is None:
        steps_n, batch, seq = REMAT_GRANITE
        rows = {"remat": _launcher_steps(dev, MOE_ARCH, steps_n, batch, seq),
                "no_remat": _launcher_steps(dev, MOE_ARCH, steps_n, batch,
                                            seq, lambda c: c.with_(
                                                remat=False))}
    if grad_peaks is None:
        from repro_torch import configs
        steps_n, batch, seq = REMAT_GRANITE
        granite = configs.get_config(MOE_ARCH).with_(use_kernels=True)
        grad_peaks = {"remat": _grad_peak(dev, granite, batch, seq),
                      "no_remat": _grad_peak(dev, granite.with_(remat=False),
                                             batch, seq)}
    res = {"granite": _dry_granite(dev, card, rows, grad_peaks)}
    res["prefill"] = _dry_prefill(dev, card)
    res["trace_solve"] = _trace_solve(dev, card)
    res["launches"] = res["trace_solve"]["launches"]
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 21: {res['phase_s']:.1f} s")
    return res


# --------------------------------------------------------------- phase 22
GEMMA2 = "gemma2-2b"
#: (b): gemma2-2b served at full width through torch_serve_demo.serve:
#: slots, max_seq, requests, longest prompt, new tokens a request
EX_SERVE = (8, 8192, 16, 6000, 32)
#: (c): the list examples, each run as written and with --kernels
EX_LISTS = ("torch_quickstart", "torch_euler_tour", "torch_tree_stats",
            "torch_connectivity")
#: (d): llama-100m: steps in all, the step of its checkpoint, batch, seq
EX_TRAIN = (10, 5, 4, 512)
#: (e): gemma2-2b's layers, prompt, teacher-forced decode steps, cache
EX_EXACT = (2, 6000, 8, 8192)
#: (e): the SMOKE engine: slots, max_seq, new tokens (the demo's)
EX_SMOKE_SERVE = (4, 192, 24)
#: what the examples printed in (c) and (d)
EX_OUT = OBS_TRACE.parent / "chip_smoke_examples.txt"
#: (a)'s library call, compiled flex_attention, is timed there
LIBRARY_TOOL = "tools/profile_lm_kernels.py"


def example_values(out, path: str = "") -> dict:
    """Every array and integer an example returned, by path (floats, its
    walls and rates, and strings left out)."""
    import dataclasses
    import torch
    if isinstance(out, torch.Tensor):
        return {path: out.cpu().numpy()}
    if isinstance(out, np.ndarray):
        return {path: out}
    if isinstance(out, (int, np.integer)) and not isinstance(out, bool):
        return {path: int(out)}
    if isinstance(out, dict):
        items = out.items()
    elif isinstance(out, (list, tuple)):
        items = enumerate(out)
    elif dataclasses.is_dataclass(out):
        items = ((f.name, getattr(out, f.name))
                 for f in dataclasses.fields(out))
    else:
        return {}
    flat: dict = {}
    for k, v in items:
        flat.update(example_values(v, f"{path}/{k}"))
    return flat


def same_values(a: dict, b: dict) -> list:
    """The paths where two :func:`example_values` differ (an array in
    dtype, shape or any bit)."""
    def same(x, y):
        if isinstance(x, np.ndarray) and isinstance(y, np.ndarray):
            return x.dtype == y.dtype and x.shape == y.shape \
                and x.tobytes() == y.tobytes()
        return type(x) is type(y) and x == y
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not same(a[k], b[k]))


def quiet(fn, text: list, title: str):
    """``fn()`` with its standard output kept in ``text`` under
    ``title``."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn()
    finally:
        text.append(f"== {title}\n{buf.getvalue()}")


def attention_rows(dev, card: str, tag: str, heads: tuple,
                   cases: list) -> dict:
    """``flash_attention`` at ``heads`` (Hq, Hkv, D, scale, soft-cap) on
    each of ``cases`` (name, b, lq, lk, per-slot offsets, window) in bf16
    and f32 against its plain version, a decode also against its
    split-and-merge; kernel, device and plain times and the bound, logged
    under ``tag``. The library call is timed by
    ``tools/profile_lm_kernels.py``."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import ATTN_TOL
    from repro_torch import devtime
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    hq, hkv, d, scale, cap = heads
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for name, b, lq, lk, offs, window in cases:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(22)
            q = torch.randn((b, hq, lq, d), generator=g, device=dev).to(dt)
            k = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)
            v = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)
            off = offs[0] if b == 1 else torch.tensor(
                offs, dtype=torch.int32, device=dev)
            kw = dict(q_offset=off, window=window, softcap=cap, scale=scale)
            key = f"{name}_{str(dt).removeprefix('torch.')}"
            out = fa_ops.flash_attention(q, k, v, **kw).float()
            want = fa_ref.attention_ref(q, k, v, **kw).float()
            torch.cuda.synchronize()
            err = max_abs_err(out, want, torch)
            if not torch.allclose(out, want, **ATTN_TOL[dt]):
                fail(f"{tag}: flash_attention {key} differs from its "
                     f"plain version by {err}")
            splits = None
            if lq == 1 and dt == torch.bfloat16:
                splits = fa_ops.decode_splits(b, hkv, hq // hkv, lk, n_sm)
                parts = fa_ref.attention_split_ref(
                    q, k, v, part_len=fa_ops.decode_part_len(lk, splits),
                    **kw).float()
                if not torch.allclose(out, parts, **ATTN_TOL[dt]):
                    fail(f"{tag}: the split-K decode {key} differs "
                         f"from its plain split-and-merge by "
                         f"{max_abs_err(out, parts, torch)}")
                del parts
            del out, want

            def kernel():
                return fa_ops.flash_attention(q, k, v, **kw)

            ms = time_ms(kernel, torch, reps=10)
            plain = time_ms(lambda: fa_ref.attention_ref(q, k, v, **kw),
                            torch, reps=5)
            kname = ("f32" if dt == torch.float32 else
                     "decode_bf16" if lq == 1 else "prefill_bf16")
            dev_ms = device_ms(kernel, torch,
                               devtime.EXPECT[f"flash_attention_{kname}"],
                               reps=5)
            bnd, by = attention_bound(b, hq, hkv, lq, d, offs, lk,
                                      q.element_size(), window=window,
                                      ops_per_s=ops_rate(dt, torch))
            rows[key] = {"b": b, "lq": lq, "lk": lk, "offsets": list(offs),
                         "window": window, "max_abs_err": err, "ms": ms,
                         "device_ms": dev_ms, "plain_ms": plain,
                         "bound_ms": bnd, "bound_by": by, "splits": splits,
                         "library_ms": None, "library": LIBRARY_TOOL}
            log(f"{tag}: flash_attention {key} B={b} Hq={hq} "
                f"Hkv={hkv} D={d} softcap={cap} window={window} Lq={lq} "
                f"Lk={lk}" + (f" offsets {list(offs)}" if b > 1 else "")
                + (f" split-K over {splits} splits" if splits else "")
                + f": max |err| {err:.3g} (tolerance {ATTN_TOL[dt]}); kernel "
                  f"{ms:.4f} ms (device time {fmt_ms(dev_ms)}), plain "
                  f"{plain:.4f} ms, bound {bnd:.4f} ms by {by} [{card}]")
            del q, k, v
        torch.cuda.empty_cache()
    return rows


def redraw_qkv_bias(params, dev) -> float:
    """Replace the zero q/k/v biases of every layer (qwen2.5's
    ``qkv_bias``) by seeded normals x 0.02 in their dtype, so that the bias
    add does work; their norm."""
    import torch
    g = torch.Generator(dev).manual_seed(SEED + 1)
    mixer = params["layers"]["mixer"]
    sq = 0.0
    for name in ("bq", "bk", "bv"):
        old = mixer[name]
        mixer[name] = (torch.randn(old.shape, generator=g, device=dev)
                       * 0.02).to(old.dtype)
        sq += float(mixer[name].float().square().sum())
    return sq ** 0.5


def serve_full_width(dev, card: str, arch: str, tag: str,
                     layers: int | None = None) -> dict:
    """``arch`` at full width and depth (``layers`` deep where given; bf16,
    kernels on; a QKV bias redrawn non-zero by :func:`redraw_qkv_bias`)
    served through
    ``examples/torch_serve_demo.py``'s ``serve`` at ``EX_SERVE``: every
    request answered with tokens in the vocabulary (never a padded row of
    the head), ``flash_attention`` exactly once a layer a prefill and a
    tick and no other kernel. Records the init's peak memory, and the
    run's with the counter reset once the weights and the cache are
    allocated; logged under ``tag``."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    from repro_torch.serve.engine import ServeConfig

    demo = load_example("torch_serve_demo")
    slots, max_seq, n_req, max_prompt, new = EX_SERVE
    cfg = configs.get_config(arch).with_(use_kernels=True)
    if layers:
        cfg = cfg.with_(num_layers=layers)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated(dev)
    bias_norm = redraw_qkv_bias(params, dev) if cfg.qkv_bias else None
    requests = traffic_requests(cfg.vocab_size, max_prompt, n_req)
    lengths = [len(r.prompt) for r in requests]
    mods = kernel_ops()
    held: dict = {}

    def on_engine(eng):
        held["eng"] = eng
        held["prefill"], held["decode"] = engine_timers(eng, torch)
        held["bytes"] = (sum(x.numel() * x.element_size()
                             for x in leaves(params)),
                         sum(x.numel() * x.element_size()
                             for x in eng.cache))  # a KVCache: k, v
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for m in mods.values():
            m.LAUNCHES = 0

    text: list = []
    res = quiet(lambda: demo.serve(
        cfg, ServeConfig(slots=slots, max_seq=max_seq, max_new_tokens=new),
        requests, dev, params=params, on_engine=on_engine), text,
        f"torch_serve_demo.serve {arch} at full width")
    torch.cuda.synchronize()
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    prefill_ms, decode_ms = held["prefill"], held["decode"]
    n_prefill = sum(len(v) for v in prefill_ms.values())
    ticks = len(decode_ms)
    out = res["out"]
    if sorted(out) != list(range(n_req)) or n_prefill != n_req:
        fail(f"{tag}: {len(out)} requests answered, {n_prefill} prefills")
    for uid, toks in out.items():
        if not 1 <= len(toks) <= new or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"{tag}: request {uid} returned {toks} (vocabulary "
                 f"{cfg.vocab_size}, head rows {cfg.padded_vocab})")
    need = cfg.num_layers * (n_prefill + ticks)
    if launches["flash_attention"] != need or launches["ssd_scan"] \
            or launches["local_chase"] or launches["mailbox_pack"]:
        fail(f"{tag}: launches {launches}; flash_attention should "
             f"launch {need} times ({cfg.num_layers} x ({n_prefill} prefills "
             f"+ {ticks} ticks))")
    w_bytes, c_bytes = held["bytes"]
    row = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "requests": n_req, "max_seq": max_seq, "prompt_lengths": lengths,
           "prefills": n_prefill, "decode_ticks": ticks,
           "generated_tokens": res["tokens"], "wall_s": res["wall_s"],
           "tokens_per_s": res["tokens_per_s"], "p50_s": res["p50_s"],
           "p90_s": res["p90_s"],
           "prefill_ms_median": {b: statistics.median(v)
                                 for b, v in sorted(prefill_ms.items())},
           "prefill_ms": {b: v for b, v in sorted(prefill_ms.items())},
           "decode_ms_median": statistics.median(decode_ms),
           "decode_ms": decode_ms, "launches": launches,
           "weight_bytes": w_bytes, "cache_bytes": c_bytes,
           "peak_memory_bytes": peak, "init_s": init_s,
           "init_peak_bytes": init_peak, "allocated_before_bytes": before,
           "qkv_bias_norm": bias_norm}
    for line in text[-1].splitlines()[1:]:
        log(f"{tag}: {line}")
    depth = configs.get_config(arch).num_layers
    log(f"{tag}: served {n_req} requests (prompts {min(lengths)}.."
        f"{max(lengths)} tokens) with {cfg.name} at full width "
        f"({cfg.num_layers} layers"
        + ("" if cfg.num_layers == depth else f" of its {depth}")
        + f", d_model {cfg.d_model}, "
        f"{str(cfg.dtype).removeprefix('torch.')}, kernels on; weights "
        f"{w_bytes / 2 ** 30:.2f} GiB, cache {c_bytes / 2 ** 30:.2f} GiB for "
        f"{slots} slots x {max_seq}): {n_prefill} prefills, {ticks} decode "
        f"ticks, {res['tokens']} tokens, {res['tokens_per_s']:.1f} tokens/s, "
        f"latency p50 / p90 {res['p50_s']:.2f} / {res['p90_s']:.2f} s; "
        f"flash_attention launches {launches['flash_attention']} = "
        f"{cfg.num_layers} x ({n_prefill} + {ticks}) [{card}]")
    log(f"  init {init_s:.2f} s, peak {init_peak / 2 ** 30:.2f} GiB during "
        f"M.init ({before / 2 ** 30:.2f} GiB allocated before it)"
        + ("" if bias_norm is None else
           f"; q/k/v biases redrawn, norm {bias_norm:.4f}"))
    log("  prefill ms per bucket (median of n): " + ", ".join(
        f"{b}: {statistics.median(v):.2f} (n={len(v)})"
        for b, v in sorted(prefill_ms.items())))
    log(f"  decode ms per tick: median {row['decode_ms_median']:.3f}, min "
        f"{min(decode_ms):.3f}, max {max(decode_ms):.3f}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB above nothing (the counter reset with the "
        f"weights and the cache allocated)")
    del held["eng"]._prefill, held["eng"]._decode
    held.clear()
    del params, res
    torch.cuda.empty_cache()
    return row


def _list_examples(dev, card: str, text: list) -> dict:
    """(c): the four list examples on the card as written, then with
    ``--kernels``: every output and counter bit-equal, ``local_chase`` and
    ``mailbox_pack`` launched with ``--kernels`` only."""
    import torch
    mods = kernel_ops()
    res = {}
    for name in EX_LISTS:
        example = load_example(name)
        runs = {}
        for flag in ((), ("--kernels",)):
            for m in mods.values():
                m.LAUNCHES = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                out = quiet(lambda: example.main(["--device", str(dev),
                                                  *flag]), text,
                            " ".join((name,) + flag))
            except AssertionError as e:
                fail(f"phase 22 (c): {name} {flag}: {e}")
            torch.cuda.synchronize()
            runs[flag] = (example_values(out), time.perf_counter() - t,
                          {k: m.LAUNCHES for k, m in mods.items()})
        (plain, wall, off), (kern, wall_k, on) = runs.values()
        differ = same_values(plain, kern)
        if differ:
            fail(f"phase 22 (c): {name} with --kernels differs at {differ}")
        if any(off.values()) or on["flash_attention"] or on["ssd_scan"] \
                or not (on["local_chase"] and on["mailbox_pack"]):
            fail(f"phase 22 (c): {name}: launches {off} as written, {on} with "
                 "--kernels")
        res[name] = {"wall_s": wall, "wall_s_kernels": wall_k,
                     "launches": on, "values": len(plain)}
        log(f"phase 22 (c): examples/{name}.py on the card: its checks pass, "
            f"{len(plain)} arrays and counters bit-equal with --kernels; wall "
            f"{wall:.2f} s as written (no launch), {wall_k:.2f} s with "
            f"--kernels (launches {on}) [{card}]")
    return res


def _train_example(dev, card: str, text: list) -> dict:
    """(d): ``examples/torch_train_100m.py`` at its full config with
    ``--use-kernels``: ``EX_TRAIN``'s steps, a checkpoint at its step into
    a fresh temporary directory, a second run resumed from it; then
    ``examples/torch_dp_compression.py``."""
    import math
    import tempfile
    import torch
    example = load_example("torch_train_100m")
    steps_n, at, batch, seq = EX_TRAIN
    mods = kernel_ops()
    for m in mods.values():
        m.LAUNCHES = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_100m_") as d:
        common = ["--ckpt-dir", d, "--ckpt-every", str(at), "--log-every",
                  "1", "--batch", str(batch), "--seq", str(seq),
                  "--use-kernels", "--device", str(dev)]
        first = quiet(lambda: example.main(["--steps", str(at)] + common),
                      text, f"torch_train_100m --steps {at}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        second = quiet(lambda: example.main(["--steps", str(steps_n)]
                                            + common), text,
                       f"torch_train_100m --steps {steps_n} (resumed)")
        torch.cuda.synchronize()
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    hist = first["history"] + second["history"]
    losses = [r["loss"] for r in hist]
    if [r["step"] for r in hist] != list(range(1, steps_n + 1)) \
            or not all(math.isfinite(x) for x in losses):
        fail(f"phase 22 (d): steps {[r['step'] for r in hist]}, losses "
             f"{losses}: the second run must resume at step {at}")
    # each layer's attention in a step's forward and its remat recompute
    need = 2 * example.llama_100m().num_layers * steps_n
    if launches["flash_attention"] != need:
        fail(f"phase 22 (d): flash_attention launched "
             f"{launches['flash_attention']} times in {steps_n} steps, not "
             f"{need}")
    warm = [r["ms"] for r in hist if r["step"] not in (1, at + 1)]
    ms = statistics.median(warm)
    res = {"params": first["params"], "losses": losses, "ms_step": ms,
           "tokens_per_s": batch * seq / (ms / 1e3), "launches": launches,
           "peak_memory_bytes": peak, "first_step_ms": hist[0]["ms"],
           "resumed_step_ms": hist[at]["ms"]}
    log(f"phase 22 (d): examples/torch_train_100m.py at its full config "
        f"({first['params'] / 1e6:.1f}M parameters, float32, {batch} x {seq} "
        f"tokens, --use-kernels): steps 1-{at}, a checkpoint at {at}, resumed"
        f" at {at} for steps {at + 1}-{steps_n}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {ms:.1f} ms a step (median of the warm steps; "
        f"first {hist[0]['ms']:.1f}, resumed {hist[at]['ms']:.1f}), "
        f"{res['tokens_per_s']:.0f} tokens/s; peak {peak / 2 ** 30:.2f} GiB "
        f"(the resumed run); launches {launches} [{card}]")
    dp = load_example("torch_dp_compression")
    t = time.perf_counter()
    out = quiet(lambda: dp.main(["--device", str(dev)]), text,
                "torch_dp_compression")
    res["dp_wall_s"] = time.perf_counter() - t
    res["dp_final_loss"] = (out["compressed"][-1], out["exact"][-1])
    log(f"phase 22 (d): examples/torch_dp_compression.py on the card: final "
        f"loss {out['compressed'][-1]:.9g} compressed, {out['exact'][-1]:.9g} "
        f"exact ({out['rel']:.3g} relative), {res['dp_wall_s']:.2f} s "
        f"[{card}]")
    return res


def on_off_logits(dev, card: str, arch: str, tag: str, seed: int,
                  prefix: int = 0, **cuts) -> dict:
    """In float32 (TF32 off), ``arch`` at full width and ``EX_EXACT``'s
    depth (a QKV bias redrawn non-zero; the config fields ``cuts`` set,
    and logged, where the float32 model would not fit the card): a prefill
    of one long prompt from ``default_rng(seed)``, behind ``prefix``
    seeded patch embeddings, and teacher-forced decode steps with kernels
    on against off (atol 2e-3, rtol 1e-3), ``flash_attention`` once a
    layer a call."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    fa = kernel_ops()["flash_attention"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, plen, steps, max_seq = EX_EXACT
    full = configs.get_config(arch)
    cfg = full.with_(num_layers=layers, dtype=torch.float32, **cuts)
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    if cfg.qkv_bias:
        redraw_qkv_bias(params, dev)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (1, plen)).astype(np.int32)).to(dev)
    pre = None if not prefix else torch.randn(
        (1, prefix, cfg.prefix_embed_dim), device=dev,
        generator=torch.Generator(dev).manual_seed(seed))
    off, fed = teacher_forced_logits(params, cfg, prompt, steps, max_seq,
                                     dev, prefix_embeds=pre)
    fa.LAUNCHES = 0
    on, _ = teacher_forced_logits(params, cfg.with_(use_kernels=True), prompt,
                                  steps, max_seq, dev, teacher=fed,
                                  prefix_embeds=pre)
    launches = fa.LAUNCHES
    torch.cuda.synchronize()
    diff = max_abs_err(on, off, torch)
    res = {"max_abs_diff": diff, "launches": launches,
           "finite": bool(torch.isfinite(on).all()), "cuts": cuts}
    window = f" (window {cfg.local_window} on layer 0)" if \
        cfg.local_window else ""
    cut = "".join(f", {k} cut to {v} from {getattr(full, k)}"
                  for k, v in cuts.items())
    log(f"{tag}: {cfg.name} at full width, {layers} layers{window}{cut}, "
        f"float32, TF32 off: "
        + (f"{prefix} patch embeddings + " if prefix else "")
        + f"prompt {plen} + {steps} teacher-forced steps, max |logits on - "
          f"off| {diff:.3g}; flash_attention launches {launches} [{card}]")
    if launches != layers * (1 + steps):
        fail(f"{tag}: {launches} launches, not {layers * (1 + steps)}")
    if not res["finite"] or not torch.allclose(on, off, atol=2e-3,
                                                rtol=1e-3):
        fail(f"{tag}: {cfg.name}'s logits with kernels on differ from off "
             f"by {diff}")
    del params, on, off
    torch.cuda.empty_cache()
    return res


def _gemma2_exactness(dev, card: str, text: list) -> dict:
    """(e): gemma2-2b's logits with kernels on against off
    (:func:`on_off_logits`), and the SMOKE engine's tokens through
    ``torch_serve_demo.serve`` (kernels on) equal to its own ``forward``'s
    greedy continuation."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig
    res = on_off_logits(dev, card, GEMMA2, "phase 22 (e)", 22)

    demo = load_example("torch_serve_demo")
    slots, seq, new = EX_SMOKE_SERVE
    cfg = configs.get_config(GEMMA2, smoke=True).with_(use_kernels=True)
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    requests = demo.demo_requests(cfg.vocab_size)
    got = quiet(lambda: demo.serve(cfg, ServeConfig(
        slots=slots, max_seq=seq, max_new_tokens=new, eos_id=-1), requests,
        dev, params=params), text, "torch_serve_demo.serve SMOKE")["out"]
    want = greedy_continuation(params, cfg, [r.prompt for r in requests],
                               new, seq, dev)
    res["engine_equal"] = got == want
    log(f"phase 22 (e): {cfg.name} SMOKE float32 through torch_serve_demo."
        f"serve (kernels on, {len(requests)} requests, {slots} slots): "
        f"{new} tokens each equal to its own forward's greedy continuation: "
        f"{got == want}")
    if got != want:
        fail(f"phase 22 (e): the engine's tokens {got} are not the greedy "
             f"continuation {want}")
    del params
    torch.cuda.empty_cache()
    return res


def examples_phase(dev, card: str = "") -> dict:
    """Phase 22: the port's examples and the gemma2-2b path they need: (a)
    ``flash_attention`` at gemma2-2b's heads, (b) gemma2-2b served at full
    width through ``examples/torch_serve_demo.py``, (c) the four list
    examples as written and with ``--kernels``, (d)
    ``examples/torch_train_100m.py`` trained and resumed and
    ``examples/torch_dp_compression.py``, (e) gemma2-2b in float32 with
    kernels on against off and the SMOKE engine against its forward.
    Their printed output goes to ``EX_OUT``."""
    t0 = time.perf_counter()
    text: list = []
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import GEMMA2_ATTN_CASES, GEMMA2_HEADS
    res = {"attention": attention_rows(dev, card, "phase 22 (a)",
                                       GEMMA2_HEADS, GEMMA2_ATTN_CASES)}
    res["serve"] = serve_full_width(dev, card, GEMMA2, "phase 22 (b)")
    res["lists"] = _list_examples(dev, card, text)
    res["train"] = _train_example(dev, card, text)
    res["exact"] = _gemma2_exactness(dev, card, text)
    EX_OUT.parent.mkdir(parents=True, exist_ok=True)
    EX_OUT.write_text("\n".join(text))
    lists = {k: sum(r["launches"][k] for r in res["lists"].values())
             for k in kernel_ops()}
    res["launches"] = {"serve": res["serve"]["launches"], "lists": lists,
                       "train": res["train"]["launches"]}
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 22: {res['phase_s']:.1f} s (the examples' output in "
        f"{EX_OUT.name})")
    return res


# --------------------------------------------------------------- phase 23
#: (a) and (b)'s list length (n/p = 2^18 at p = 16); (c) runs at a
#: quarter of it, (d) at an eighth, for the phase's time limit
CONFIG_N = 1 << 22
#: (b)'s mesh: 2 nodes x 2 rows x 4 columns
MESH3 = ((2, 2, 4), ("node", "row", "col"))
#: the counters recorded for each variant
CONFIG_COUNTERS = ("rounds", "pd_rounds", "chase_msgs", "pd_msgs",
                   "fixup_msgs", "reversal_msgs", "attempts")
#: counters every variant's solve must leave at 0
CONFIG_ZEROS = ("dropped", "sub_overflow", "store_miss", "undelivered")
#: the variants' rows, beside the other phases' files
CONFIG_OUT = OBS_TRACE.parent / "chip_smoke_configs.json"


def config_variants(n: int) -> list:
    """Phase 23's variants as (group, name, instance, mesh, indirection,
    ListRankConfig fields). An instance is ("list", n, gamma) for
    ``gen_list(n, gamma, seed=1)`` or ("forest", n, weights) for
    ``gen_random_lists(n, 64, seed=5, weighted=True)`` with its int32
    weights or integer-valued float32 ones; a mesh "flat" (16 PEs),
    "grid" (4 x 4) or "mesh3" (``MESH3``); an indirection None (direct,
    or the tuner's choice), ("grid",) over every axis, or ("topology",
    intra axes, inter axes). (a) and (b) run at ``n`` elements, (c) at
    n / 4, (d) at n / 8; (c) and (d) come first, so that the host makes
    (a)'s instance while the card solves theirs."""
    n_c, n_d = n // 4, n // 8
    a = ("list", n, 1.0)
    d = ("list", n_d, 1.0)
    topo = ("topology", ("col",), ("node", "row"))
    out = []
    for gamma in (0.0, 0.5, 1.0):  # Fig 2
        for contract in (False, True):
            out.append(("c", f"gamma {gamma} "
                        f"{'contraction' if contract else 'plain'}",
                        ("list", n_c, gamma), "flat", None,
                        {"local_contraction": contract}))
    out += [("d", name, d, "flat", None, fields) for name, fields in (
        ("reversal", {"avoid_reversal": False}),
        ("allgather base", {"base_case": "allgather"}),
        ("no dedup", {"dedup_requests": False}),
        ("unpacked wire", {"wire_packing": False, "srs_rounds": 2,
                           "local_contraction": True}),
        ("tuned rulers", {"ruler_fraction": None}),
        ("algorithm auto", {"algorithm": "auto"}),
        ("capacity estimation", {"capacity_estimation": True}))]
    out += [("d", f"forest {w}", ("forest", n_d, w), "flat", None, {})
            for w in ("int32", "float32")]
    for algo in ("srs", "doubling"):  # Fig 3
        for mesh, ind in (("flat", None), ("grid", ("grid",))):
            out.append(("a", f"{algo} {'grid' if ind else 'direct'}", a,
                        mesh, ind, {"algorithm": algo}))
    out += [("b", "direct", a, "mesh3", None, {}),  # Fig 4
            ("b", "grid", a, "mesh3", ("grid",), {}),
            ("b", "topology", a, "mesh3", topo, {}),
            ("b", "auto_indirection", a, "mesh3", None,
             {"auto_indirection": True})]
    return out


def config_instance(inst) -> tuple:
    """(succ, rank, oracle succ, oracle rank) of a ``config_variants``
    instance, made on the host."""
    from repro_torch.core.listrank import instances, rank_list_seq
    kind, n, arg = inst
    if kind == "list":
        succ, rank = instances.gen_list(n, gamma=arg, seed=1)
    else:
        succ, rank = instances.gen_random_lists(n, num_lists=64, seed=5,
                                                weighted=True)
        if arg == "float32":
            # integer-valued weights: every partial sum is exact in any
            # summation order (sums below 3 n < 2^24)
            rank = np.random.default_rng(5).integers(
                0, 4, n).astype(np.float32)
            rank[succ == np.arange(n)] = 0
    return (succ, rank) + tuple(rank_list_seq(succ, rank))


def _config_instance_child(inst) -> tuple:
    """:func:`config_instance` in a worker process (the host's instances
    and oracles are made there while the card solves)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    return config_instance(inst)


def _config_solve(dev, succ, rank, mesh, ind, cfg) -> dict:
    """One solve with both kernels' counts reset just before it: outputs,
    stats, wall and launches."""
    import torch
    from repro_torch.core.listrank import rank_list_with_stats
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    lc_ops.LAUNCHES = 0
    mp_ops.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    s, r, st = rank_list_with_stats(succ, rank, mesh, cfg=cfg,
                                    indirection=ind, seed=SEED, device=dev,
                                    stage_counters=True)
    torch.cuda.synchronize()
    return {"succ": s, "rank": r, "stats": st,
            "wall_s": time.perf_counter() - t,
            "launches": {"local_chase": lc_ops.LAUNCHES,
                         "mailbox_pack": mp_ops.LAUNCHES}}


def _config_checks(what: str, runs: dict, oracle: tuple,
                   fields: dict) -> None:
    """Fail unless both runs equal the oracle, each other (bits and
    integer counters), leave ``CONFIG_ZEROS`` at 0, and launched each
    kernel where (and only where) the path reaches it."""
    import torch
    on, off = runs["on"], runs["off"]
    for key, run in runs.items():
        s, r = run["succ"].cpu().numpy(), run["rank"].cpu().numpy()
        if not (np.array_equal(s, oracle[0]) and r.dtype == oracle[1].dtype
                and r.tobytes() == oracle[1].tobytes()):
            fail(f"phase 23 {what}: kernels {key}: output differs from "
                 f"rank_list_seq")
        bad = {k: run["stats"][k] for k in CONFIG_ZEROS if run["stats"][k]}
        if bad:
            fail(f"phase 23 {what}: kernels {key}: {bad}")
    if not (torch.equal(on["succ"], off["succ"]) and on["rank"].cpu().numpy(
            ).tobytes() == off["rank"].cpu().numpy().tobytes()):
        fail(f"phase 23 {what}: kernels on and off differ in bits")
    ints_on, ints_off = (int_counters(on["stats"]),
                         int_counters(off["stats"]))
    if ints_on != ints_off:
        fail(f"phase 23 {what}: counters differ, on {ints_on}, off "
             f"{ints_off}")
    if any(off["launches"].values()):
        fail(f"phase 23 {what}: kernels off launched {off['launches']}")
    cfg = {"local_contraction": True, "wire_packing": True, **fields}
    for name, flag in (("local_chase", "local_contraction"),
                       ("mailbox_pack", "wire_packing")):
        got = on["launches"][name]
        if cfg[flag] and got < 1:
            fail(f"phase 23 {what}: {name} was not launched with "
                 f"{flag} on")
        if not cfg[flag] and got:
            fail(f"phase 23 {what}: {name} launched {got} times with "
                 f"{flag} off")


def host_pool():
    """Two spawned worker processes for the host's instances and
    oracles."""
    return concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))


def config_futures(pool, n: int = CONFIG_N) -> dict:
    """{instance: its future on ``pool``} for phase 23's variants at
    ``n``, submitted in the order the variants use them."""
    return {inst: pool.submit(_config_instance_child, inst)
            for inst in dict.fromkeys(v[2] for v in config_variants(n))}


def configs_phase(dev, card: str = "", n: int = CONFIG_N,
                  made=None) -> dict:
    """Phase 23: the solver's configurations, each variant of
    :func:`config_variants` solved through ``rank_list_with_stats`` at p
    = 16 with both kernels on, then off (:func:`_config_checks`); per
    variant the walls, ``CONFIG_COUNTERS``, the collectives per stage and
    the launches, written to ``CONFIG_OUT``. The instances and their
    oracles come from ``made`` (:func:`config_futures`, submitted early by
    :func:`run`), or are made here in two worker processes while the card
    solves."""
    from repro_torch.core.listrank import sim_mesh
    t0 = time.perf_counter()
    meshes = {"flat": sim_mesh(P_MAIN),
              "grid": sim_mesh((4, 4), ("row", "col")),
              "mesh3": sim_mesh(*MESH3)}
    pool = None
    if made is None:
        pool = host_pool()
        made = config_futures(pool, n)
    try:
        rows, launches, wait_s = _config_rows(
            dev, card, config_variants(n), made, meshes)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    for row in rows:
        if row["group"] == "b":
            log(f"phase 23 (b) messages by phase, {row['name']} (hops "
                f"{row['hops']}): chase {row['chase_msgs']}, base "
                f"{row['pd_msgs']}, propagate+fix {row['fixup_msgs']}")
    res = {"rows": rows, "launches": launches, "host_wait_s": wait_s,
           "phase_s": time.perf_counter() - t0}
    CONFIG_OUT.parent.mkdir(parents=True, exist_ok=True)
    CONFIG_OUT.write_text(json.dumps(res, indent=1))
    log(f"phase 23: {len(rows)} variants, {res['phase_s']:.1f} s "
        f"({wait_s:.1f} s waiting for the host's instances and oracles); "
        f"launches {launches}")
    return res


def _config_rows(dev, card: str, variants: list, made: dict,
                 meshes: dict) -> tuple:
    """Phase 23's variants solved and checked in turn, each instance taken
    from its future in ``made`` (and dropped after its last use): (rows,
    launches summed over the kernels-on solves, seconds spent waiting for
    instances)."""
    from repro_torch.core.listrank import (IndirectionSpec, ListRankConfig,
                                           tuner)
    last_use = {v[2]: i for i, v in enumerate(variants)}
    rows, launches = [], {k: 0 for k in kernel_ops()}
    wait_s = 0.0
    for i, (group, name, inst, mesh_key, ind, fields) in enumerate(
            variants):
        t = time.perf_counter()
        succ, rank, s_ref, r_ref = made[inst].result()
        wait_s += time.perf_counter() - t
        mesh = meshes[mesh_key]
        spec = (None if ind is None else IndirectionSpec.grid(
            mesh.axis_names) if ind[0] == "grid" else
            IndirectionSpec.topology(*ind[1:]))
        what = f"({group}) {name}"
        runs = {}
        for key, on in (("on", True), ("off", False)):
            cfg = ListRankConfig(**fields, use_pallas=on, use_pallas_pack=on)
            runs[key] = _config_solve(dev, succ, rank, mesh, spec, cfg)
        _config_checks(what, runs, (s_ref, r_ref), fields)
        st = runs["on"]["stats"]
        hops = (spec.hops if spec is not None else tuner.choose_indirection(
            ListRankConfig(), mesh.axis_names, mesh.axis_sizes,
            inst[1]).hops if fields.get("auto_indirection") else
            (tuple(mesh.axis_names),))
        coll = {label: dict(c) for label, c in st["stage_collectives"]}
        a2a = sum(c.get("all_to_all", 0) for c in coll.values())
        row = {"group": group, "name": name, "n": inst[1],
               "instance": list(inst), "mesh": list(mesh.axis_sizes),
               "hops": [list(h) for h in hops], "config": fields,
               "wall_on_s": runs["on"]["wall_s"],
               "wall_off_s": runs["off"]["wall_s"],
               **{k: st[k] for k in CONFIG_COUNTERS},
               "stage_collectives": coll, "all_to_all": a2a,
               "launches": runs["on"]["launches"]}
        rows.append(row)
        for k, v in row["launches"].items():
            launches[k] += v
        log(f"phase 23 {what}: n={inst[1]} mesh {row['mesh']} hops "
            f"{row['hops']}: exact, on = off; walls on / off "
            f"{row['wall_on_s']:.3f} / {row['wall_off_s']:.3f} s; "
            + ", ".join(f"{k} {row[k]}" for k in CONFIG_COUNTERS)
            + f"; launches {row['launches']} ({a2a} all_to_all counted) "
              f"[{card}]")
        log("    collectives per stage: " + "; ".join(
            f"{label} " + ",".join(f"{k} {v}" for k, v in c.items())
            for label, c in coll.items()))
        for key in [k for k, j in last_use.items() if j == i]:
            del made[key]
        del runs
    return rows, launches, wait_s



# --------------------------------------------------------------- phase 24
#: the head-dim-128 decoders (GQA groups 5, 3 and 4), served in this order
D128_ARCHS = ("qwen2.5-14b", "phi4-mini-3.8b", "pixtral-12b")
PIXTRAL = "pixtral-12b"
#: (d) 2.: pixtral's multimodal prefill: batch, patch embeddings a row (a
#: 512 x 512 image at 16-pixel patches), text tokens a row, cache
#: positions, greedy decode steps
PIXTRAL_MM = (2, 1024, 64, 2048, 32)
#: (e): pixtral's patch embeddings in front of ``EX_EXACT``'s prompt
D128_EXACT_PREFIX = 1024


def _pixtral_prefix(dev, card: str) -> dict:
    """(d) 2.: pixtral-12b at full width and depth (bf16, kernels on)
    through the model API the reference has: ``M.prefill`` of
    ``PIXTRAL_MM``'s seeded patch embeddings in front of its text tokens,
    then greedy ``M.decode_step``s at positions P + T + i. Fails unless
    every logit is finite, the cache holds exactly P + T filled positions a
    row after the prefill and one more after each step, every token is in
    the vocabulary, and ``flash_attention`` launched once a layer a
    call."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    b, n_patch, n_text, max_seq, steps = PIXTRAL_MM
    cfg = configs.get_config(PIXTRAL).with_(use_kernels=True)
    params = M.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    batch = {"prefix_embeds": torch.randn(
        (b, n_patch, cfg.prefix_embed_dim), device=dev,
        generator=torch.Generator(dev).manual_seed(SEED + 2)),
        "tokens": torch.from_numpy(np.random.default_rng(24).integers(
            2, cfg.vocab_size, (b, n_text)).astype(np.int32)).to(dev)}
    cache = M.init_cache(cfg, b, max_seq, dev)
    mods = kernel_ops()

    def filled(want: int) -> bool:
        """Whether each row's cache holds keys (in some layer and kv head)
        at exactly its first ``want`` positions."""
        got = cache.k.ne(0).any(dim=-1).any(dim=2).any(dim=0)  # (B, S)
        return bool(got[:, :want].all()) and int(got.sum()) == b * want

    start = n_patch + n_text
    for m in mods.values():
        m.LAUNCHES = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, cache = M.prefill(params, batch, cfg, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    if lg.shape != (b, 1, cfg.padded_vocab) or not torch.isfinite(lg).all():
        fail(f"phase 24 (d): the prefill's logits {tuple(lg.shape)} are not "
             f"finite")
    if not filled(start):
        fail(f"phase 24 (d): the prefill did not fill exactly positions "
             f"0..{start - 1} of each row's cache")
    tok = torch.argmax(lg[:, 0, :cfg.vocab_size], dim=-1).view(b, 1).int()
    toks, step_ms, finite = [tok], [], True
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = M.decode_step(params, tok, start + i, cfg, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        finite &= bool(torch.isfinite(lg).all())
        tok = torch.argmax(lg[:, 0, :cfg.vocab_size], dim=-1).view(b, 1).int()
        toks.append(tok)
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    out = torch.cat(toks, dim=1).cpu()
    if not finite or not filled(start + steps):
        fail(f"phase 24 (d): after {steps} decode steps from position "
             f"{start}: finite logits {finite}, the cache not filled to "
             f"{start + steps}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"phase 24 (d): tokens {out.tolist()} outside the vocabulary")
    need = cfg.num_layers * (1 + steps)
    if launches != {**{k: 0 for k in mods}, "flash_attention": need}:
        fail(f"phase 24 (d): launches {launches}; flash_attention should "
             f"launch {need} = {cfg.num_layers} x (1 + {steps}) times")
    res = {"batch": b, "patches": n_patch, "text": n_text, "max_seq": max_seq,
           "steps": steps, "prefill_ms": prefill_ms,
           "decode_ms_median": statistics.median(step_ms),
           "decode_ms": step_ms, "tokens": out.tolist(),
           "launches": launches}
    log(f"phase 24 (d): {cfg.name} at full width "
        f"({str(cfg.dtype).removeprefix('torch.')}, kernels on): "
        f"M.prefill of {b} x ({n_patch} patch embeddings of width "
        f"{cfg.prefix_embed_dim} + {n_text} tokens) into a {max_seq}-position "
        f"cache in {prefill_ms:.2f} ms, finite logits, positions 0..{start - 1}"
        f" filled; {steps} greedy decode steps from position {start}, "
        f"{res['decode_ms_median']:.2f} ms a step (median), every token in "
        f"the vocabulary; flash_attention launches {need} = "
        f"{cfg.num_layers} x (1 + {steps}) [{card}]")
    del params, cache, batch, lg
    torch.cuda.empty_cache()
    return res


def d128_phase(dev, card: str = "") -> dict:
    """Phase 24: the head-dim-128 decoders at full width: (a)
    ``flash_attention`` at their heads (``D128_HEADS``, ``D128_ATTN_CASES``),
    (b) qwen2.5-14b (its QKV biases redrawn non-zero), (c) phi4-mini-3.8b
    and (d) pixtral-12b served through ``examples/torch_serve_demo.py``,
    then pixtral's patch-embedding prefill and decode, (e) each in float32
    with kernels on against off (pixtral behind a 1024-patch prefix)."""
    import torch
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import D128_ATTN_CASES, D128_HEADS
    log(f"phase 24: {torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB "
        f"allocated at its start")
    res: dict = {"attention": {
        arch: attention_rows(dev, card, f"phase 24 (a) {arch}",
                             D128_HEADS[arch], D128_ATTN_CASES)
        for arch in D128_ARCHS}}
    res["serve"] = {arch: serve_full_width(dev, card, arch,
                                           f"phase 24 ({part})")
                    for arch, part in zip(D128_ARCHS, "bcd")}
    res["prefix"] = _pixtral_prefix(dev, card)
    res["exact"] = {arch: on_off_logits(
        dev, card, arch, "phase 24 (e)", 24,
        prefix=D128_EXACT_PREFIX if arch == PIXTRAL else 0)
        for arch in D128_ARCHS}
    res["launches"] = {k: sum(r["launches"][k] for r in res["serve"].values())
                       + res["prefix"]["launches"][k] for k in kernel_ops()}
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 24: {res['phase_s']:.1f} s; launches {res['launches']}")
    return res


# --------------------------------------------------------------- phase 25
KIMI = "kimi-k2-1t-a32b"
#: (b): kimi-k2's depth at full width: one layer's three stacks of 384
#: experts take 31.5 GiB in bf16, its embedding and untied head 4.4 GiB;
#: its 61 layers would need 1.9 TiB
K2_SERVE_LAYERS = 1
#: (c): the experts of the float32 check at ``EX_EXACT``'s depth (top-8 and
#: the shared expert kept): at 384, one float32 layer's experts alone take
#: 63 GiB
K2_EXACT_EXPERTS = 64


def kimi_phase(dev, card: str = "") -> dict:
    """Phase 25: kimi-k2 at full width: (a) ``flash_attention`` at its heads
    (``K2_HEADS``: GQA group 8, D 112) on ``D128_ATTN_CASES``, (b) served
    through ``examples/torch_serve_demo.py`` at ``K2_SERVE_LAYERS`` deep,
    its 384-expert top-8 MoE layer and shared expert on every prefill and
    tick, (c) in float32 with kernels on against off, its experts cut to
    ``K2_EXACT_EXPERTS``."""
    import torch
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import D128_ATTN_CASES, K2_HEADS
    log(f"phase 25: {torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB "
        f"allocated at its start")
    res: dict = {"attention": attention_rows(dev, card, "phase 25 (a)",
                                             K2_HEADS, D128_ATTN_CASES)}
    res["serve"] = serve_full_width(dev, card, KIMI, "phase 25 (b)",
                                    layers=K2_SERVE_LAYERS)
    res["exact"] = on_off_logits(dev, card, KIMI, "phase 25 (c)", 25,
                                 num_experts=K2_EXACT_EXPERTS)
    res["launches"] = res["serve"]["launches"]
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 25: {res['phase_s']:.1f} s; launches {res['launches']}")
    return res


if __name__ == "__main__":
    main()
