"""The port's SSD scan against the JAX package's: the plain versions
(``ssd_ref``, ``ssd_chunked_ref``) on the kernel sweep of
``tests/test_kernels.py`` (atol 1e-5, rtol 1e-4), the wrapper's CPU path
against the Pallas kernel in interpret mode, its gradients in all six
inputs against ``jax.grad`` through the reference's custom vjp, and the
wrapper's errors. The CUDA kernel's twins of these checks are in
``test_torch_cuda.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_kernels
from _torch_kernel_inputs import (SSD_CASES, SSD_RAGGED, SSD_TOL,
                                  ssd_inputs, ssd_training_inputs)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels.ssd_scan import ops as ssd_ops_jax
from repro.kernels.ssd_scan import ref as ssd_ref_jax
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref


def _jax(t):
    return None if t is None else jnp.asarray(t.numpy())


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or SSD_TOL))


_ref_j = jax.jit(ssd_ref_jax.ssd_ref, static_argnames=("return_state",))
_chunked_j = jax.jit(ssd_ref_jax.ssd_chunked_ref,
                     static_argnames=("chunk", "return_state"))


def test_ssd_cases_match_the_kernel_sweep():
    assert SSD_CASES == test_kernels.SSD_CASES


@pytest.mark.parametrize("skip", [True, False], ids=["D", "noD"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_versions_match_jax(case, skip):
    bt, l, h, g, n, p, chunk = case
    x, dt, A, B, C, D = ssd_inputs(bt, l, h, g, n, p, seed=sum(case))
    D = D if skip else None
    args_t, args_j = (x, dt, A, B, C, D), tuple(map(_jax, (x, dt, A, B, C,
                                                           D)))
    _close(ssd_ref.ssd_ref(*args_t), _ref_j(*args_j))
    _close(ssd_ref.ssd_chunked_ref(*args_t, chunk=chunk),
           _chunked_j(*args_j, chunk=chunk))
    # a carried initial state, and the final state
    s0 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(bt, h, n, p)).astype(np.float32))
    y_t, s_t = ssd_ref.ssd_ref(*args_t, initial_state=s0, return_state=True)
    y_j, s_j = _ref_j(*args_j, initial_state=_jax(s0), return_state=True)
    _close(y_t, y_j)
    _close(s_t, s_j)
    y_t, s_t = ssd_ref.ssd_chunked_ref(*args_t, chunk=chunk, initial_state=s0,
                                       return_state=True)
    y_j, s_j = _chunked_j(*args_j, chunk=chunk, initial_state=_jax(s0),
                          return_state=True)
    _close(y_t, y_j)
    _close(s_t, s_j)


@pytest.mark.parametrize("case", SSD_CASES)
def test_wrapper_cpu_path_matches_pallas(case):
    """The CPU path (the sequential scan) against the Pallas kernel, run in
    interpret mode by the reference's own op."""
    bt, l, h, g, n, p, chunk = case
    args = ssd_inputs(bt, l, h, g, n, p, seed=sum(case))
    before = ssd_ops.LAUNCHES
    y = ssd_ops.ssd_scan(*args, chunk)
    assert ssd_ops.LAUNCHES == before  # the CPU launches nothing
    assert y.shape == args[0].shape and y.dtype == torch.float32
    _close(y, ssd_ops_jax.ssd_scan(*map(_jax, args), chunk, True))


@functools.partial(jax.jit, static_argnums=(7,))
def _grads_j(x, dt, A, B, C, D, w, chunk):
    def f(x, dt, A, B, C, D):
        return jnp.sum(ssd_ops_jax.ssd_scan(x, dt, A, B, C, D, chunk, True)
                       * w)
    return jax.grad(f, argnums=(0, 1, 2, 3, 4, 5))(x, dt, A, B, C, D)


@functools.partial(jax.jit, static_argnums=(6,))
def _grads_j_nod(x, dt, A, B, C, w, chunk):
    def f(x, dt, A, B, C):
        return jnp.sum(ssd_ops_jax.ssd_scan(x, dt, A, B, C, None, chunk, True)
                       * w)
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(x, dt, A, B, C)


@pytest.mark.parametrize("skip", [True, False], ids=["D", "noD"])
@pytest.mark.parametrize("case", SSD_CASES[1:])
def test_gradients_match_jax_custom_vjp(case, skip):
    """d(sum(y * w))/d(x, dt, A, B, C, D) through the autograd.Function
    (backward: autograd through the recomputed ``ssd_ref``) against
    ``jax.grad`` through the reference's custom vjp (backward: ``jax.vjp``
    of its ``ssd_ref``); atol 1e-5, rtol 1e-4 (A and D sum over every
    position, so their gradients run into the hundreds)."""
    bt, l, h, g, n, p, chunk = case
    x, dt, A, B, C, D = ssd_inputs(bt, l, h, g, n, p, seed=sum(case) + 1)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=x.shape).astype(np.float32))
    ins = [x, dt, A, B, C] + ([D] if skip else [])
    leaves = [t.clone().requires_grad_() for t in ins]
    y = ssd_ops.ssd_scan(*leaves[:5], leaves[5] if skip else None, chunk)
    got = torch.autograd.grad((y * w).sum(), leaves)
    if skip:
        want = _grads_j(*map(_jax, ins), _jax(w), chunk)
    else:
        want = _grads_j_nod(*map(_jax, ins), _jax(w), chunk)
    assert len(got) == len(want) == len(ins)
    for name, g_t, g_j in zip("x dt A B C D".split(), got, want):
        assert tuple(g_t.shape) == np.shape(g_j), name
        _close(g_t, g_j)


def test_no_skip_gives_no_d_gradient():
    x, dt, A, B, C, _ = ssd_inputs(1, 16, 2, 1, 4, 8, seed=0)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y = ssd_ops.ssd_scan(*leaves, None, 8)
    y.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


def test_chunked_ref_gradient_is_nan_like_the_reference():
    """A reference caveat the port keeps: at L = 512 with the model's init
    (dt = softplus(0), A = -1) the masked exponentials of
    ``ssd_chunked_ref`` overflow, so its gradient is NaN in both packages,
    while the wrapper's (through ``ssd_ref``) is finite."""
    bt, l, h, g, n, p, chunk = 1, 512, 2, 1, 4, 4, 16
    x, _, _, B, C, D = ssd_inputs(bt, l, h, g, n, p, seed=5)
    dt = torch.full((bt, l, h), float(np.log1p(np.exp(0.0))))
    A = -torch.ones(h)

    def grad_dt_t(fn):
        d = dt.clone().requires_grad_()
        return torch.autograd.grad(fn(x, d, A, B, C, D).sum(), d)[0]

    g_chunked = grad_dt_t(lambda *a: ssd_ref.ssd_chunked_ref(*a, chunk=chunk))
    g_j = jax.jit(jax.grad(lambda d: ssd_ref_jax.ssd_chunked_ref(
        _jax(x), d, _jax(A), _jax(B), _jax(C), _jax(D), chunk=chunk).sum()))(
        _jax(dt))
    assert torch.isnan(g_chunked).any() and np.isnan(np.asarray(g_j)).any()
    g_op = grad_dt_t(lambda *a: ssd_ops.ssd_scan(*a, chunk=chunk))
    assert torch.isfinite(g_op).all()


def _bad(**change):
    args = dict(zip("x dt A B C D".split(),
                    ssd_inputs(1, 8, 4, 2, 4, 8, seed=0)))
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    (dict(x=torch.zeros(1, 8, 4)), "x must be"),
    (dict(dt=torch.zeros(1, 8, 3)), "disagree"),
    (dict(A=torch.zeros(3)), "A and D"),
    (dict(D=torch.zeros(2)), "A and D"),
    (dict(B=torch.zeros(1, 8, 3, 4), C=torch.zeros(1, 8, 3, 4)), "multiple"),
    (dict(x=torch.zeros(1, 8, 4, 8, dtype=torch.float64)), "dtype"),
    (dict(B=torch.zeros(1, 8, 2, 4, dtype=torch.bfloat16)), "dtype"),
    (dict(dt=torch.zeros(1, 8, 4, dtype=torch.bfloat16)), "float32"),
])
def test_wrapper_rejects_bad_shapes_and_dtypes(change, match):
    with pytest.raises(ValueError, match=match):
        ssd_ops.ssd_scan(**_bad(**change))
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_scan(**_bad(), chunk=0)


@pytest.mark.parametrize("case", SSD_CASES + SSD_RAGGED)
def test_three_stage_matches_references(case):
    """The bf16 kernel's decomposition (chunk states, state pass, chunk
    scan), in float32 without rounding points, against ``ssd_ref`` and the
    JAX package's ``ssd_ref`` and Pallas kernel (interpret mode; the
    reference op takes ``ssd_ref`` itself for a ragged L) within SSD_TOL."""
    bt, l, h, g, n, p, chunk = case
    args = ssd_inputs(bt, l, h, g, n, p, seed=sum(case))
    y = ssd_ref.ssd_three_stage_ref(*args, chunk=chunk)
    _close(y, ssd_ref.ssd_ref(*args))
    args_j = tuple(map(_jax, args))
    _close(y, _ref_j(*args_j))
    _close(y, ssd_ops_jax.ssd_scan(*args_j, chunk, True))


def test_three_stage_bf16_points_in_the_training_regime():
    """With the kernel's bf16 rounding points, at a chunk log-decay past
    -180 (dt = softplus(N(0, 1)), A = -1): within 2e-2 of ``ssd_ref`` and
    of the JAX package's, and a finite gradient in every input."""
    bt, l, h, g, n, p, chunk = 1, 512, 2, 1, 32, 16, 256
    args = ssd_training_inputs(bt, l, h, g, n, p, seed=5,
                               dtype=torch.bfloat16)
    dt, A = args[1], args[2]
    assert float((dt * A).reshape(bt, -1, chunk, h).sum(2).max()) < -180
    y = ssd_ref.ssd_three_stage_ref(*args, chunk=chunk, bf16_points=True)
    assert y.dtype == torch.bfloat16
    tol = dict(atol=2e-2, rtol=2e-2)
    _close(y, ssd_ref.ssd_ref(*args).float(), **tol)
    _close(y, _ref_j(*(_jax(t.float()) for t in args)), **tol)
    leaves = [t.float().requires_grad_() for t in args]
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=args[0].shape).astype(np.float32))
    out = ssd_ref.ssd_three_stage_ref(*leaves, chunk=chunk, bf16_points=True)
    grads = torch.autograd.grad((out * w).sum(), leaves)
    assert all(torch.isfinite(t).all() for t in grads)
