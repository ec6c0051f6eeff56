"""Kernel inputs shared by the port's CPU and card tests (numpy and the
port only — no jax, so the card's tests can import it)."""
import numpy as np
import torch

from repro_torch.core.listrank import instances, local


def chains(b, m, seed, gamma=0.3):
    """(b, m) local-chase input as local contraction builds it: local
    chains of a List(n, gamma) instance, stops as weight-0 self-loops."""
    succ, rank = instances.gen_list(b * m, gamma=gamma, seed=seed,
                                    num_lists=3)
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 7, b * m).astype(np.int32)
    w[succ == np.arange(b * m)] = 0
    base = torch.arange(b, dtype=torch.int32) * m
    succ_l, dist0, steps, _ = local.chase_input(
        torch.from_numpy(succ).reshape(b, m), torch.from_numpy(w).reshape(b, m),
        base, m)
    return succ_l.numpy(), dist0.numpy(), steps


def float_dist(dist, seed):
    """Random float32 weights on the same links (0 at stops)."""
    rng = np.random.default_rng(seed)
    out = rng.normal(scale=3.0, size=dist.shape).astype(np.float32)
    out[dist == 0] = 0.0
    return out


def pack_inputs(p, q, n_rows, seed, dtype):
    """W=5 word-planes (one holding float32 bit patterns) and per-PE
    slots: distinct cells for shipping messages, some out of range."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-2 ** 31, 2 ** 31 - 1, (p, q), dtype=np.int64)
            .astype(np.int32) for _ in range(4)]
    if dtype == "float32":
        cols[2] = rng.normal(size=(p, q)).astype(np.float32).view(np.int32)
    cols.append(rng.integers(0, 2, (p, q)).astype(np.int32))  # valid word
    slots = np.stack([rng.permutation(n_rows + q)[:q] for _ in range(p)])
    slots[:, ::7] = n_rows + 3  # non-shipping rows (several per PE)
    return cols, slots.astype(np.int32)
