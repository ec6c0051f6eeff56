"""The reference's ruler permutations, for injecting into the port's
solves (``perm_fn_from_numpy``): shared by the port's parity tests."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np


class ReferencePerms(dict):
    """``{(level, pe, cap): perm}`` filled on demand with the reference's
    ruler permutations, ``permutation(fold_in(fold_in(PRNGKey(seed),
    level), pe), cap)``. ``legacy=True`` draws them under the legacy
    threefry mode the committed goldens were produced with (scoped: the
    flag is restored on exit); ``legacy=False`` under the mode in force,
    which is what an in-process reference solve draws."""

    def __init__(self, seed: int, p: int, legacy: bool = True):
        super().__init__()
        self.seed, self.p, self.legacy = seed, p, legacy

    def __missing__(self, key):
        level, _, cap = key
        mode = (jax.threefry_partitionable(False) if self.legacy
                else contextlib.nullcontext())
        with mode:
            k = jax.random.fold_in(jax.random.PRNGKey(self.seed), level)
            perms = np.asarray(jax.vmap(lambda i: jax.random.permutation(
                jax.random.fold_in(k, i), cap))(
                    jnp.arange(self.p, dtype=jnp.int32)), np.int32)
        for pe in range(self.p):
            self[(level, pe, cap)] = perms[pe]
        return self[key]
