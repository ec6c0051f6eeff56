"""The port's kernels against the JAX package's: the plain torch versions
(the CPU path of every wrapper) equal the Pallas kernels in interpret
mode and the jnp/numpy references exactly, for int32 and float32. Their
twins on the card are in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_chase import kernel as lc_kernel_jax
from repro.kernels.local_chase import ref as lc_ref_jax
from repro.kernels.mailbox_pack import kernel as mp_kernel_jax
from repro.kernels.mailbox_pack import ref as mp_ref_jax
from _torch_kernel_inputs import chains, float_dist, pack_inputs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.kernels.local_chase import ops as lc_ops, ref as lc_ref
from repro_torch.kernels.mailbox_pack import ops as mp_ops, ref as mp_ref


@pytest.mark.parametrize("b,m", [(1, 64), (8, 64), (3, 200)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_local_chase_plain_matches_pallas(b, m, dtype):
    succ, dist, steps = chains(b, m, seed=b * 31 + m)
    if dtype == "float32":
        dist = float_dist(dist, seed=m)
    s_t, d_t = lc_ops.local_chase(torch.from_numpy(succ),
                                  torch.from_numpy(dist), steps)
    s_p, d_p = lc_kernel_jax.local_chase_pallas(
        jnp.asarray(succ), jnp.asarray(dist), steps, interpret=True)
    s_j, d_j = lc_ref_jax.local_chase_ref(jnp.asarray(succ),
                                          jnp.asarray(dist), steps)
    for s_ref, d_ref in ((s_p, d_p), (s_j, d_j)):
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_ref))
        assert d_t.numpy().tobytes() == np.asarray(d_ref).tobytes()


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_local_chase_plain_matches_sequential(dtype):
    """Integer-valued weights: every order of the adds is exact, so the
    doubling equals the O(m) sequential walk bit for bit."""
    succ, dist, steps = chains(4, 128, seed=5)
    dist = dist.astype(dtype)
    s_t, d_t = lc_ref.local_chase_ref(torch.from_numpy(succ),
                                      torch.from_numpy(dist), steps)
    s_q, d_q = lc_ref_jax.sequential_chase_ref(succ, dist)
    s_q2, d_q2 = lc_ref.sequential_chase_ref(succ, dist)
    np.testing.assert_array_equal(s_t.numpy(), s_q)
    assert d_t.numpy().tobytes() == d_q.tobytes()
    np.testing.assert_array_equal(s_q2, s_q)
    assert d_q2.tobytes() == d_q.tobytes()


@pytest.mark.parametrize("p,q,n_rows", [(1, 40, 32), (4, 37, 24), (2, 16, 64)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_mailbox_pack_plain_matches_pallas(p, q, n_rows, dtype):
    cols, slots = pack_inputs(p, q, n_rows, seed=p * q + n_rows, dtype=dtype)
    out = mp_ref.mailbox_pack_ref(torch.from_numpy(np.stack(cols, 1)),
                                  torch.from_numpy(slots), n_rows)
    assert out.shape == (p, len(cols), n_rows) and out.dtype == torch.int32
    for pe in range(p):
        pe_cols = tuple(jnp.asarray(c[pe]) for c in cols)
        pe_slots = jnp.asarray(slots[pe])
        ref_pl = mp_kernel_jax.mailbox_pack_pallas(pe_cols, pe_slots, n_rows,
                                                   interpret=True)
        ref_x = mp_ref_jax.mailbox_pack_ref(pe_cols, pe_slots, n_rows)
        assert out[pe].numpy().tobytes() == np.asarray(ref_pl).tobytes()
        assert out[pe].numpy().tobytes() == np.asarray(ref_x).tobytes()


def test_wrappers_reject_other_devices():
    """Off the CPU a wrapper launches its kernel or raises — it never
    quietly takes the plain version."""
    s = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        lc_ops.local_chase(s, s, 3)
    with pytest.raises(ValueError):
        mp_ops.mailbox_pack([s], s.long(), s, 2, 4)
