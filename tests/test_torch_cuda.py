"""The port's CUDA kernels against their plain torch versions, on the
card (marker ``torch_cuda``; they skip without CUDA or nvcc). The file
imports no jax, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m torch_cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from _torch_kernel_inputs import chains, float_dist, pack_inputs
from repro_torch.kernels import build
from repro_torch.kernels.local_chase import ops as lc_ops, ref as lc_ref
from repro_torch.kernels.mailbox_pack import ops as mp_ops, ref as mp_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.torch_cuda
@pytest.mark.parametrize("b,m", [(3, 64), (16, 1 << 16)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_local_chase_cuda_matches_plain(cuda, b, m, dtype):
    succ, dist, steps = chains(b, m, seed=11)
    if dtype == "float32":
        dist = float_dist(dist, seed=3)
    s, d = torch.from_numpy(succ).to(cuda), torch.from_numpy(dist).to(cuda)
    before = lc_ops.local_chase.launches
    s_k, d_k = lc_ops.local_chase(s, d, steps)
    torch.cuda.synchronize()
    assert lc_ops.local_chase.launches == before + 1
    s_r, d_r = lc_ref.local_chase_ref(s, d, steps)
    assert torch.equal(s_k, s_r)
    assert torch.equal(d_k.view(torch.int32), d_r.view(torch.int32))


@pytest.mark.torch_cuda
@pytest.mark.parametrize("p,q,n_rows", [(4, 37, 24), (16, 5000, 4096)])
def test_mailbox_pack_cuda_matches_plain(cuda, p, q, n_rows):
    cols, slots = pack_inputs(p, q, n_rows, seed=9, dtype="float32")
    cols = [torch.from_numpy(c).to(cuda) for c in cols]
    slots = torch.from_numpy(slots).to(cuda)
    before = mp_ops.mailbox_pack.launches
    out = mp_ops.mailbox_pack(cols, slots, n_rows)
    torch.cuda.synchronize()
    assert mp_ops.mailbox_pack.launches == before + 1
    assert torch.equal(out, mp_ref.mailbox_pack_ref(cols, slots, n_rows))
