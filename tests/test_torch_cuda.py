"""The port's CUDA kernels against their plain torch versions, on the
card (marker ``torch_cuda``; they skip without CUDA or nvcc). The file
imports no jax, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m torch_cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from _torch_kernel_inputs import (ATTN_CASES, ATTN_TOL, attn_inputs, chains,
                                  float_dist, pack_inputs)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
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


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_flash_attention_cuda_matches_plain(cuda, case, dtype):
    b, hq, hkv, lq, lk, d, kw = ATTN_CASES[case]
    q, k, v = (t.to(cuda) for t in attn_inputs(b, hq, hkv, lq, lk, d,
                                                seed=case, dtype=dtype))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               fa_ref.attention_ref(q, k, v, **kw).float(),
                               **ATTN_TOL[dtype])


@pytest.mark.torch_cuda
@pytest.mark.parametrize("d", fa_ops.HEAD_DIMS)
def test_flash_attention_cuda_decode_per_slot(cuda, d):
    """One query per slot at its own position over a 300-key cache, GQA
    group 8, every head dim the kernel is built for."""
    q, k, v = (t.to(cuda) for t in attn_inputs(5, 16, 2, 1, 300, d, seed=d))
    offsets = torch.tensor([0, 63, 64, 200, 299], dtype=torch.int32,
                           device=cuda)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, q_offset=offsets, window=100)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    torch.testing.assert_close(
        out, fa_ref.attention_ref(q, k, v, q_offset=offsets, window=100),
        **ATTN_TOL[torch.float32])


@pytest.mark.torch_cuda
def test_flash_attention_cuda_rejects_what_it_does_not_take(cuda):
    q, k, v = (t.to(cuda) for t in attn_inputs(1, 4, 2, 8, 8, 48, seed=0))
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, k, v)
    q, k, v = (t.to(cuda) for t in attn_inputs(1, 4, 2, 8, 8, 32, seed=0))
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
