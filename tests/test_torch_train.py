"""The port's training path against the JAX package's, at the SMOKE
configs in float32: the LR schedules, AdamW given the same gradients and
state, the next-token loss, the packed data pipeline (byte for byte), the
Mamba-2 mixer and forward (kernels on and off), the loss and every
parameter gradient of one train step for mamba2-130m, tinyllama-1.1b and
hymba-1.5b,
gradient accumulation, and the training entry point end to end on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data import packing as packing_j
from repro.data import pipeline as pipeline_j
from repro.models import layers as LJ
from repro.models import model as MJ
from repro.models import params as PJ
from repro.optim import adamw as adamw_j
from repro.optim import schedule as sched_j
from repro.train import steps as steps_j
from repro_torch import configs
from repro_torch.core.listrank import sim_mesh
from repro_torch.data import packing, pipeline
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as train_launch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.optim import adamw, schedule as sched
from repro_torch.train import steps

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(0)
#: float32 forward parity, as tests/test_torch_models.py
ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _pair(arch, use_kernels=True, seed=0):
    """(jax cfg, port cfg, jax params, port params) of a SMOKE config."""
    cfg_j = jax_configs.get_config(arch, smoke=True).with_(
        use_kernels=use_kernels)
    cfg_t = configs.get_config(arch, smoke=True).with_(
        use_kernels=use_kernels)
    params_j = MJ.init(jax.random.PRNGKey(seed), cfg_j)
    params_t = P.from_reference(_np_tree(params_j), cfg_t, "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _batch(cfg, batch=2, seq=32, step=0):
    host = pipeline_j.global_batch(pipeline_j.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch), step)
    return host, {k: torch.from_numpy(v) for k, v in host.items()}


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("name,kw", [
    ("cosine_warmup", dict(warmup_steps=10, total_steps=100)),
    ("cosine_warmup", dict(warmup_steps=0, total_steps=5, min_ratio=0.0)),
    ("rsqrt", dict(warmup_steps=10)),
    ("constant", dict(warmup_steps=10, total_steps=100)),
])
def test_schedules_match_jax(name, kw):
    step = np.arange(0, 120, dtype=np.int32)
    got = getattr(sched, name)(torch.from_numpy(step), **kw)
    want = getattr(sched_j, name)(jnp.asarray(step), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


# -------------------------------------------------------------------- adamw
def _opt_tree(dtype):
    """A small tree with a low-precision leaf and a float32 leaf, as a
    model's (bf16 matrices, f32 a_log / dt_bias)."""
    return {"w": RNG.normal(size=(6, 5)).astype(np.float32),
            "blk": {"a_log": RNG.normal(size=(5,)).astype(np.float32),
                    "b": RNG.normal(size=(7,)).astype(np.float32)}}, \
        {"w": dtype, "blk": {"a_log": np.float32, "b": dtype}}


def _to_t(a, dt):
    if dt == "bf16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, np.float32))


def _to_j(a, dt):
    return jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32)


def _cmp_tree(got, want, rtol=2e-6, atol=1e-7):
    g, w = P.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert str(a.dtype).removeprefix("torch.") == jnp.dtype(b.dtype).name
        if a.dtype == torch.bfloat16:  # at most one bf16 rounding apart
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("master", [True, False])
def test_adamw_update_matches_jax_given_equal_gradients(state_dtype,
                                                        param_dtype, master):
    """Three steps, each given the same numpy gradients on both sides (the
    optimizer alone; a full train step's update is about lr * sign(g), so
    sign noise near g = 0 would dominate a parameter comparison)."""
    vals, kinds = _opt_tree(param_dtype)
    cfg_kw = dict(lr=1e-2, state_dtype=state_dtype, master_weights=master,
                  grad_clip=0.5)
    cfg_t, cfg_j = adamw.AdamWConfig(**cfg_kw), adamw_j.AdamWConfig(**cfg_kw)
    p_t = P.map_tree(_to_t, vals, kinds)
    p_j = jax.tree.map(_to_j, vals, kinds)
    s_t, s_j = adamw.init(p_t, cfg_t), adamw_j.init(p_j, cfg_j)
    assert sorted(s_t) == sorted(s_j)
    update_j = jax.jit(functools.partial(adamw_j.update, cfg=cfg_j))
    for i in range(3):
        g = P.map_tree(lambda a: RNG.normal(size=a.shape).astype(np.float32),
                       vals)
        scale = np.float32(0.5 + 0.25 * i)
        p_t, s_t, m_t = adamw.update(P.map_tree(_to_t, g, kinds), s_t, p_t,
                                     cfg_t, torch.tensor(scale))
        p_j, s_j, m_j = update_j(jax.tree.map(_to_j, g, kinds), s_j, p_j,
                                 lr_scale=jnp.asarray(scale))
        _cmp_tree(p_t, p_j)
        for k in ("m", "v") + (("master",) if master else ()):
            _cmp_tree(s_t[k], s_j[k])
        assert int(s_t["step"]) == int(s_j["step"]) == i + 1
        assert s_t["step"].dtype == torch.int32
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m_t["lr"]), float(m_j["lr"]),
                                   rtol=1e-7)


def test_adamw_int8_states_initialise_and_step():
    """``state_dtype="int8"``: the moments start as zero ``QInt8`` blocks
    of the parameters' shapes, and a step requantizes them (the parity
    with the reference is in tests/test_torch_compression.py)."""
    from repro_torch.runtime.compression import QInt8
    params = {"w": torch.zeros((3, 100)), "b": torch.zeros(7)}
    cfg = adamw.AdamWConfig(state_dtype="int8", lr=0.1)
    opt = adamw.init(params, cfg)
    for k in ("m", "v"):
        for name, p in params.items():
            q = opt[k][name]
            assert isinstance(q, QInt8) and q.shape == tuple(p.shape)
            assert q.q.dtype == torch.int8 and q.scale.dtype == torch.float32
            assert not q.dequantize().any()
    grads = {"w": torch.linspace(-1, 1, 300).reshape(3, 100),
             "b": torch.ones(7)}
    new, opt, metrics = adamw.update(grads, opt, params, cfg)
    assert int(opt["step"]) == 1 and np.isfinite(float(metrics["grad_norm"]))
    assert isinstance(opt["m"]["w"], QInt8) and opt["m"]["w"].q.any()
    assert bool((new["w"] != 0).any())


# --------------------------------------------------------------------- loss
def test_next_token_loss_matches_jax():
    cfg = configs.get_config("tinyllama-1.1b", smoke=True)
    logits = (RNG.normal(size=(3, 17, 64)) * 3).astype(np.float32)
    labels = RNG.integers(0, 64, (3, 17)).astype(np.int32)
    labels[0, 5:] = -100
    labels[2, :3] = -1
    got = steps.next_token_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), cfg, 1e-3)
    want = steps_j.next_token_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   cfg, 1e-3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full_like(labels, -100)  # nothing to predict: loss 0
    assert float(steps.next_token_loss(torch.from_numpy(logits),
                                       torch.from_numpy(none), cfg)) == 0.0


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("pack", [True, False])
def test_global_batch_is_byte_identical(pack):
    kw = dict(vocab_size=512, seq_len=96, global_batch=4, pack=pack)
    for step in range(3):
        got = pipeline.global_batch(pipeline.DataConfig(**kw), step)
        want = pipeline_j.global_batch(pipeline_j.DataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
    dev = pipeline.device_batch(pipeline.DataConfig(**kw), 2, "cpu")
    assert dev["tokens"].dtype == torch.int32
    assert dev["tokens"].numpy().tobytes() == want["tokens"].tobytes()


def test_segment_metadata_through_the_list_ranking_port():
    """The packer's segment chains ranked by the port's distributed solver
    on 4 virtual PEs equal the numpy oracle and the reference's packing."""
    rng = np.random.default_rng(3)
    docs = [rng.integers(2, 100, int(n)).astype(np.int32)
            for n in rng.integers(5, 300, 40)]
    packed = packing.pack_documents(docs, 64)
    packed_j = packing_j.pack_documents(docs, 64)
    assert packed.rows.tobytes() == packed_j.rows.tobytes()
    assert packed.succ.tobytes() == packed_j.succ.tobytes()
    term, after = packing.segment_metadata(packed)
    term_m, after_m = packing.segment_metadata(packed, mesh=sim_mesh(4),
                                               device="cpu")
    term_j, after_j = packing_j.segment_metadata(packed_j)
    assert np.array_equal(term_m, term) and np.array_equal(after_m, after)
    assert np.array_equal(term, term_j) and np.array_equal(after, after_j)
    for a, b in zip(packing.token_metadata(packed, term, after),
                    packing_j.token_metadata(packed_j, term_j, after_j)):
        assert np.array_equal(a, b)


# -------------------------------------------------------------------- mamba
@pytest.mark.parametrize("use_kernels", [True, False])
def test_mamba_mixer_matches_jax(use_kernels):
    """Kernels on: the port's CPU path (the sequential scan) against the
    Pallas kernel in interpret mode; off: ``ssd_chunked_ref`` on both
    sides. Non-zero a_log, dt_bias and conv_b so they count."""
    cfg_j = jax_configs.get_config("mamba2-130m", smoke=True).with_(
        use_kernels=use_kernels)
    cfg_t = configs.get_config("mamba2-130m", smoke=True).with_(
        use_kernels=use_kernels)
    p_j = PJ.init_params(jax.random.PRNGKey(4), LJ.mamba_specs(cfg_j))
    for name in ("a_log", "dt_bias", "conv_b"):
        p_j[name] = jnp.asarray(RNG.normal(size=p_j[name].shape) * 0.3,
                                p_j[name].dtype)
    p_t = P.load_tree(_np_tree(p_j), L.mamba_specs(cfg_t), "cpu")
    x = RNG.normal(size=(2, 48, cfg_t.d_model)).astype(np.float32)
    out_t, none = L.mamba_mixer(p_t, torch.from_numpy(x), cfg_t)
    out_j, _ = jax.jit(lambda p, x: LJ.mamba_mixer(p, x, cfg_j))(p_j, x)
    assert none is None
    _close(out_t, out_j)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mamba_forward_matches_jax(use_kernels):
    cfg_j, cfg_t, params_j, params_t = _pair("mamba2-130m", use_kernels, 1)
    toks = RNG.integers(0, cfg_t.vocab_size, (2, 48)).astype(np.int32)
    before = ssd_ops.LAUNCHES
    logits_t, aux = M.forward(params_t, {"tokens": torch.from_numpy(toks)},
                              cfg_t)
    assert ssd_ops.LAUNCHES == before  # the CPU launches nothing
    logits_j, _ = jax.jit(lambda p, t: MJ.forward(p, {"tokens": t}, cfg_j))(
        params_j, toks)
    assert logits_t.shape == (2, 48, cfg_t.padded_vocab)
    assert float(aux) == 0.0
    _close(logits_t, logits_j)


# --------------------------------------------------------------- train step
#: gradient parity of a whole train step: float32 sums over the batch and
#: every layer in another order than XLA's (about 1e-6 relative)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _jax_value_and_grad(cfg_j, tcfg_j):
    return jax.jit(jax.value_and_grad(
        lambda p, b: steps_j.loss_fn(p, b, cfg_j, tcfg_j), has_aux=True))


@pytest.mark.parametrize("arch", ["mamba2-130m", "tinyllama-1.1b",
                                  "hymba-1.5b"])
def test_loss_and_every_gradient_match_jax(arch):
    """``value_and_grad`` of the port's loss (kernel wrappers on: the plain
    forward on the CPU, backward through the plain versions) against
    ``jax.value_and_grad(loss_fn)`` (Pallas forward in interpret mode,
    custom-vjp backward through the references)."""
    cfg_j, cfg_t, params_j, params_t = _pair(arch, True, 2)
    host, batch = _batch(cfg_t)
    (loss_t, ex_t), g_t = steps.value_and_grad(params_t, batch, cfg_t,
                                               steps.TrainConfig())
    (loss_j, ex_j), g_j = _jax_value_and_grad(cfg_j, steps_j.TrainConfig())(
        params_j, host)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert float(ex_t["aux_loss"]) == float(ex_j["aux_loss"]) == 0.0
    flat_t, flat_j = P.leaves(g_t), jax.tree.leaves(g_j)
    assert len(flat_t) == len(flat_j) == len(P.leaves(params_t))
    for (path, _), a, b in zip(jax.tree_util.tree_flatten_with_path(g_j)[0],
                               flat_t, flat_j):
        assert tuple(a.shape) == b.shape, path
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_step_with_microbatches_matches_jax():
    """Two microbatches: the loss and gradient norm of one step against the
    reference's, and the accumulated gradients against the mean of the
    two halves' gradients; a second step moves the loss."""
    cfg_j, cfg_t, params_j, params_t = _pair("mamba2-130m", True, 3)
    host, batch = _batch(cfg_t, batch=4, seq=32, step=1)
    kw = dict(microbatches=2, warmup_steps=2, total_steps=10)
    tcfg_t, tcfg_j = steps.TrainConfig(**kw), steps_j.TrainConfig(**kw)
    opt_t = adamw.init(params_t, tcfg_t.optimizer)
    opt_j = adamw_j.init(params_j, tcfg_j.optimizer)
    new_t, opt_t2, m_t = steps.train_step(params_t, opt_t, batch, cfg_t,
                                          tcfg_t)
    _, _, m_j = jax.jit(functools.partial(
        steps_j.train_step, cfg=cfg_j, tcfg=tcfg_j))(params_j, opt_j, host)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5)
    assert int(opt_t2["step"]) == 1
    halves = [steps.value_and_grad(params_t, {k: v[i:i + 2] for k, v in
                                              batch.items()}, cfg_t, tcfg_t)
              for i in (0, 2)]
    mean = P.map_tree(lambda a, b: (a + b) / 2, halves[0][1], halves[1][1])
    np.testing.assert_allclose(float(m_t["grad_norm"]),
                               float(adamw.global_norm(mean)), rtol=1e-6)
    _, _, m_t2 = steps.train_step(new_t, opt_t2, batch, cfg_t, tcfg_t)
    assert float(m_t2["loss"]) < float(m_t["loss"])


def test_eval_step_is_the_loss():
    cfg = configs.get_config("mamba2-130m", smoke=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    _, batch = _batch(cfg)
    (loss, _), _ = steps.value_and_grad(params, batch, cfg,
                                        steps.TrainConfig())
    out = steps.eval_step(params, batch, cfg, steps.TrainConfig())
    assert float(out["loss"]) == float(loss)


@pytest.mark.parametrize("arch", ["mamba2-130m", "tinyllama-1.1b"])
def test_train_entry_point_runs_on_the_cpu(arch, capsys):
    history = train_launch.main([
        "--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq",
        "32", "--log-every", "1", "--device", "cpu", "--use-kernels"])
    assert [h["step"] for h in history] == [1, 2, 3]
    for h in history:
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("step     1 loss")
    assert '"last_loss"' in out[-1]


def test_rsqrt_schedule_in_train_step_raises_like_the_reference():
    """The reference's train_step passes total_steps to every schedule and
    its rsqrt takes only warmup_steps: TypeError in both packages."""
    cfg_j, cfg_t, params_j, params_t = _pair("mamba2-130m", True, 0)
    host, batch = _batch(cfg_t, seq=16)
    tcfg_t = steps.TrainConfig(schedule="rsqrt")
    tcfg_j = steps_j.TrainConfig(schedule="rsqrt")
    with pytest.raises(TypeError, match="total_steps"):
        steps.train_step(params_t, adamw.init(params_t, tcfg_t.optimizer),
                         batch, cfg_t, tcfg_t)
    with pytest.raises(TypeError, match="total_steps"):  # while tracing
        jax.jit(functools.partial(steps_j.train_step, cfg=cfg_j,
                                  tcfg=tcfg_j))(
            params_j, adamw_j.init(params_j, tcfg_j.optimizer), host)
