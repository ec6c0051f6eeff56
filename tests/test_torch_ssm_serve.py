"""The SSM serving path of the port (mamba2-130m, hymba-1.5b) against the
JAX package's, at the SMOKE configs in float32 with the port's plain
kernel versions: ``ssd_decode_step``, the cached ``mamba_mixer`` and
``hymba_mixer``, the model's ``init_cache`` / ``prefill`` /
``decode_step``, the serving engine's tokens against the greedy
continuation of the JAX package's ``forward`` (and the JAX engine's
admission fault, pinned), ``from_reference`` on a bfloat16 hymba tree
and the serving CLI. One hymba train step is in test_torch_train.py."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels.ssd_scan import ops as ssd_ops_j
from repro.kernels.ssd_scan import ref as ssd_ref_j
from repro.models import layers as LJ
from repro.models import model as MJ
from repro.models import params as PJ
from repro.serve import engine as engine_j
from repro_torch import configs
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SSM = ["mamba2-130m", "hymba-1.5b"]
RNG = np.random.default_rng(0)
#: ssd_decode_step against the reference (the kernels' ssd_scan bound)
SSD_TOL = dict(atol=1e-5, rtol=1e-4)
#: a layer's float32 outputs and caches (tests/test_torch_models.py's ATOL)
ATOL = 1e-4
#: the model's logits and caches (tests/test_models.py's decode bound)
MODEL_ATOL = 2e-3
#: the engine test's traffic: 2 slots, 5 requests of 3..150 tokens (prefill
#: buckets 128 and 256, hymba's 16-token window crossed), 6 tokens each
SLOTS, MAX_SEQ, NEW = 2, 256, 6
PROMPT_LENGTHS = [72, 3, 150, 129, 21]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or dict(atol=ATOL, rtol=1e-5)))


def _leaves(cache):
    """The tensors of a port cache in the JAX pytree's leaf order."""
    parts = cache if type(cache) is tuple else (cache,)
    return [t for part in parts for t in part]


@functools.lru_cache(maxsize=None)
def _params_j(arch, seed):
    """The JAX package's SMOKE parameters, drawn once a file."""
    cfg = jax_configs.get_config(arch, smoke=True)
    return jax.jit(MJ.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _pair(arch, seed=0, **kw):
    cfg_j = jax_configs.get_config(arch, smoke=True).with_(**kw)
    cfg_t = configs.get_config(arch, smoke=True).with_(**kw)
    params_j = _params_j(arch, seed)
    params_t = P.from_reference(_np_tree(params_j), cfg_t, "cpu")
    return cfg_j, cfg_t, params_j, params_t


# ------------------------------------------------------- ssd_decode_step
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_the_reference(g):
    """One step against the reference's on random inputs; then L steps from
    a state equal the chunked scan from that state over the L tokens."""
    bt, h, p, n, l = 2, 4, 8, 16, 12
    x, dt = _x(bt, l, h, p), np.abs(_x(bt, l, h)) * 0.5
    a, d = -np.abs(_x(h)) - 0.1, _x(h)
    b, c = _x(bt, l, g, n), _x(bt, l, g, n)
    s0 = _x(bt, h, n, p)
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, dt=dt, a=a, b=b, c=c, d=d, s0=s0).items()}
    y, s = ssd_ops.ssd_decode_step(t["x"][:, 0], t["dt"][:, 0], t["a"],
                                   t["b"][:, 0], t["c"][:, 0], t["d"], t["s0"])
    y_j, s_j = jax.jit(ssd_ops_j.ssd_decode_step)(x[:, 0], dt[:, 0], a,
                                                  b[:, 0], c[:, 0], d, s0)
    assert s.dtype == torch.float32
    _close(y, y_j, **SSD_TOL)
    _close(s, s_j, **SSD_TOL)

    ys, s = [], t["s0"]
    for i in range(l):
        y, s = ssd_ops.ssd_decode_step(t["x"][:, i], t["dt"][:, i], t["a"],
                                       t["b"][:, i], t["c"][:, i], t["d"], s)
        ys.append(y)
    want_y, want_s = ssd_ref.ssd_chunked_ref(
        t["x"], t["dt"], t["a"], t["b"], t["c"], t["d"], chunk=4,
        initial_state=t["s0"], return_state=True)
    _close(torch.stack(ys, dim=1), want_y, **SSD_TOL)
    _close(s, want_s, **SSD_TOL)
    ref_y, ref_s = jax.jit(lambda *a: ssd_ref_j.ssd_chunked_ref(
        *a, chunk=4, initial_state=s0, return_state=True))(x, dt, a, b, c, d)
    _close(want_y, ref_y, **SSD_TOL)
    _close(want_s, ref_s, **SSD_TOL)


# ----------------------------------------------------------------- layers
def _mixer_case(kind, is_local):
    """(apply_t, apply_j, port cache, jax cache): the layer with a cache on
    the same parameters (non-zero a_log, dt_bias and conv_b so they count),
    both sides taking (x, positions, cache_pos[, valid_len])."""
    arch = "mamba2-130m" if kind == "mamba" else "hymba-1.5b"
    cfg_j = jax_configs.get_config(arch, smoke=True)
    cfg_t = configs.get_config(arch, smoke=True).with_(use_kernels=True)
    specs = (LJ.mamba_specs, L.mamba_specs) if kind == "mamba" else \
        (LJ.hymba_specs, L.hymba_specs)
    p_j = PJ.init_params(jax.random.PRNGKey(4), specs[0](cfg_j))
    mp = p_j if kind == "mamba" else p_j["mamba"]
    for name in ("a_log", "dt_bias", "conv_b"):
        mp[name] = jnp.asarray(RNG.normal(size=mp[name].shape) * 0.3,
                               mp[name].dtype)
    p_t = P.load_tree(_np_tree(p_j), specs[1](cfg_t), "cpu")
    b, s = 2, 40
    ssm_t = L.init_ssm_cache(cfg_t, b, torch.float32, "cpu")
    ssm_j = LJ.SSMCache(*(jnp.zeros(t.shape, jnp.float32) for t in ssm_t))
    if kind == "mamba":
        def apply_t(x, pos, cache, cache_pos, valid_len=None):
            return L.mamba_mixer(p_t, x, cfg_t, cache=cache,
                                 valid_len=valid_len)

        apply_j = jax.jit(lambda x, pos, cache, cache_pos: LJ.mamba_mixer(
            p_j, x, cfg_j, cache=cache))
        return apply_t, apply_j, ssm_t, ssm_j
    kv_shape = (b, cfg_t.n_kv_heads, s, cfg_t.resolved_head_dim)
    kv_t = L.KVCache(torch.zeros(kv_shape), torch.zeros(kv_shape))

    def apply_t(x, pos, cache, cache_pos, valid_len=None):
        return L.hymba_mixer(p_t, x, cfg_t, positions=pos, is_local=is_local,
                             cache=cache, cache_pos=cache_pos,
                             valid_len=valid_len)

    apply_j = jax.jit(lambda x, pos, cache, cache_pos: LJ.hymba_mixer(
        p_j, x, cfg_j, positions=pos, is_local=jnp.asarray(is_local),
        cache=cache, cache_pos=cache_pos))
    kv_j = LJ.KVCache(jnp.zeros(kv_shape), jnp.zeros(kv_shape))
    return apply_t, apply_j, (kv_t, ssm_t), (kv_j, ssm_j)


@pytest.mark.parametrize("kind,is_local", [("mamba", None),
                                           ("hymba", True),
                                           ("hymba", False)])
def test_mixer_with_a_cache_matches_jax(kind, is_local):
    """A 32-token prefill from a zero cache, then 4 single-token decodes
    (past hymba's 16-token window): every output and every cache leaf after
    every call. Then a prefill right-padded to 32 with ``valid_len`` 9
    leaves the SSM cache of an unpadded 9-token prefill."""
    apply_t, apply_j, cache_t, cache_j = _mixer_case(kind, is_local)
    b, l = 2, 32
    d = configs.get_config("mamba2-130m" if kind == "mamba" else "hymba-1.5b",
                           smoke=True).d_model
    x = _x(b, l + 4, d)
    pos = np.broadcast_to(np.arange(l + 4, dtype=np.int32), (b, l + 4))

    def both(lo, hi, cache_pos, cache_t, cache_j):
        out_t, cache_t = apply_t(torch.from_numpy(x[:, lo:hi]),
                                 torch.from_numpy(np.array(pos[:, lo:hi])),
                                 cache_t, cache_pos)
        out_j, cache_j = apply_j(x[:, lo:hi], pos[:, lo:hi], cache_j,
                                 cache_pos)
        _close(out_t, out_j)
        for got, want in zip(_leaves(cache_t), jax.tree.leaves(cache_j)):
            _close(got, want)
        return cache_t, cache_j

    cache_t, cache_j = both(0, l, 0, cache_t, cache_j)
    for t in range(l, l + 4):
        cache_t, cache_j = both(t, t + 1, t, cache_t, cache_j)

    _, _, fresh_t, fresh_j = _mixer_case(kind, is_local)
    xp = torch.from_numpy(np.concatenate([x[:, :9], _x(b, l - 9, d)], 1))
    _, fresh_t = apply_t(xp, torch.from_numpy(np.array(pos[:, :l])), fresh_t,
                         0, valid_len=9)
    _, fresh_j = apply_j(x[:, :9], pos[:, :9], fresh_j, 0)
    for got, want in zip(_leaves(fresh_t)[-2:], jax.tree.leaves(fresh_j)[-2:]):
        _close(got, want)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("arch", SSM)
def test_cache_prefill_decode_match_jax(arch):
    """``init_cache``, an 8-token ``prefill`` and 8 ``decode_step``s against
    the JAX package's (logits and every cache leaf), and against the port's
    own ``forward`` (tests/test_models.py's decode consistency)."""
    cfg_j, cfg_t, params_j, params_t = _pair(arch, seed=1)
    b, seq = 2, 16
    toks = RNG.integers(0, cfg_t.vocab_size, (b, seq)).astype(np.int32)
    full, _ = M.forward(params_t, {"tokens": torch.from_numpy(toks)}, cfg_t)
    cache_t = M.init_cache(cfg_t, b, seq, device="cpu")
    cache_j = MJ.init_cache(cfg_j, b, seq)
    for got, want in zip(_leaves(cache_t), jax.tree.leaves(cache_j)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        assert not got.any()
    half = seq // 2
    lg_t, cache_t = M.prefill(params_t, {"tokens": torch.from_numpy(
        toks[:, :half])}, cfg_t, cache_t)
    lg_j, cache_j = jax.jit(lambda p, t, c: MJ.prefill(
        p, {"tokens": t}, cfg_j, c))(params_j, toks[:, :half], cache_j)
    tol = dict(atol=MODEL_ATOL, rtol=1e-5)
    _close(lg_t, lg_j, **tol)
    _close(lg_t[:, -1], full[:, half - 1].detach(), **tol)
    decode_j = jax.jit(lambda p, t, pos, c: MJ.decode_step(p, t, pos, cfg_j,
                                                          c))
    for t in range(half, seq):
        lg_t, cache_t = M.decode_step(params_t, torch.from_numpy(
            toks[:, t:t + 1]), t, cfg_t, cache_t)
        lg_j, cache_j = decode_j(params_j, toks[:, t:t + 1], t, cache_j)
        _close(lg_t, lg_j, **tol)
        _close(lg_t[:, 0], full[:, t].detach(), **tol)
        for got, want in zip(_leaves(cache_t), jax.tree.leaves(cache_j)):
            _close(got, want, **tol)


# ----------------------------------------------------------------- engine
def _requests(vocab):
    rng = np.random.default_rng(1)
    return [(uid, rng.integers(2, vocab, n).astype(np.int32))
            for uid, n in enumerate(PROMPT_LENGTHS)]


@functools.lru_cache(maxsize=None)
def _greedy(arch):
    """Each request's NEW greedy tokens from the JAX package's ``forward``
    on the prompt plus the tokens so far: the requests batched, right-padded
    to one length (causal, so the padding changes no earlier logit)."""
    cfg = jax_configs.get_config(arch, smoke=True)
    params = _params_j(arch, 0)
    reqs = _requests(cfg.vocab_size)
    seqs = [list(p) for _, p in reqs]
    toks = np.zeros((len(reqs), MAX_SEQ), np.int32)
    fwd = jax.jit(lambda p, t: MJ.forward(p, {"tokens": t}, cfg)[0])
    for _ in range(NEW):
        for i, s in enumerate(seqs):
            toks[i, :len(s)] = s
        logits = np.asarray(fwd(params, toks))
        for i, s in enumerate(seqs):
            s.append(int(np.argmax(logits[i, len(s) - 1, :cfg.vocab_size])))
    jax.clear_caches()
    return {uid: s[len(p):] for (uid, p), s in zip(reqs, seqs)}


def _serve_config():
    return dict(slots=SLOTS, max_seq=MAX_SEQ, max_new_tokens=NEW, eos_id=-1)


@pytest.mark.parametrize("arch", SSM)
def test_engine_tokens_are_the_models_greedy_tokens(arch):
    """More requests than slots (slots reused), both prefill buckets: the
    port's engine gives the greedy continuation of the JAX ``forward``."""
    _, cfg_t, _, params_t = _pair(arch, seed=0, use_kernels=True)
    eng = ServingEngine(params_t, cfg_t, ServeConfig(**_serve_config()),
                        device="cpu")
    for uid, prompt in _requests(cfg_t.vocab_size):
        eng.submit(Request(uid=uid, prompt=prompt))
    assert eng.run_to_completion() == _greedy(arch)


@pytest.mark.parametrize("arch", SSM + ["tinyllama-1.1b"])
def test_reference_engine_admission_fault_is_pinned(arch):
    """The JAX engine's tokens differ from the greedy continuation for every
    request of the models that carry SSM state (its padded prefill, its
    second decode of the last prompt token and its stale conv tail), and
    equal it for a KV-only model. The port does not copy the fault (the
    test above); if the reference is repaired, this fails."""
    cfg = jax_configs.get_config(arch, smoke=True)
    params = _params_j(arch, 0)
    eng = engine_j.ServingEngine(params, cfg,
                                 engine_j.ServeConfig(**_serve_config()))
    for uid, prompt in _requests(cfg.vocab_size):
        eng.submit(engine_j.Request(uid=uid, prompt=prompt))
    got = eng.run_to_completion()
    jax.clear_caches()
    want = _greedy(arch)
    if arch in SSM:
        assert all(got[uid] != want[uid] for uid in want), (got, want)
    else:
        assert got == want


# ------------------------------------------------------- weights and CLI
def test_from_reference_carries_a_bfloat16_hymba_tree():
    """Every leaf bit for bit, hymba's float32 ``a_log``, ``dt_bias`` and
    ``d_skip`` inside a bfloat16 model included."""
    cfg_j = jax_configs.get_config("hymba-1.5b", smoke=True).with_(
        dtype=jnp.bfloat16)
    cfg_t = configs.get_config("hymba-1.5b", smoke=True).with_(
        dtype=torch.bfloat16)
    # the reference's tree of that config, drawn with numpy
    tree = jax.tree.map(lambda a: np.asarray(RNG.normal(size=a.shape),
                                             a.dtype), MJ.abstract(cfg_j))
    assert tree["layers"]["mixer"]["mamba"]["a_log"].dtype == np.float32
    params = P.from_reference(tree, cfg_t, "cpu")
    assert params["layers"]["mixer"]["mamba"]["a_log"].dtype == torch.float32
    assert params["layers"]["mixer"]["attn"]["wq"].dtype == torch.bfloat16
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0], P.leaves(params)):
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        bits = np.int16 if want.dtype.name == "bfloat16" else np.int32
        view = torch.int16 if bits is np.int16 else torch.int32
        assert np.array_equal(got.view(view).numpy(), want.view(bits)), path


def test_serve_cli_serves_hymba_on_the_cpu():
    env = one_thread_env(PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert '"requests": 8' in proc.stdout
