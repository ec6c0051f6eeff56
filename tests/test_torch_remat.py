"""Activation checkpointing (``cfg.remat``) in the port's model stack,
on the CPU in float32 at the SMOKE configs:

- the loss and every gradient with remat on equal those with remat off,
  bit for bit, for every family (a dense decoder, mamba, the hybrid, the
  encoder-decoder, and the MoE decoder under a (4, 1) mesh, where it runs
  the expert-parallel MoE) and each of the three policies (``nothing``,
  ``save_moe``, ``offload_moe``), kernel wrappers on;
- with remat on, each family's loss and gradients equal the reference's
  (``jax.value_and_grad`` of its remat'd ``loss_fn``) within
  ``tests/test_torch_train.py``'s gradient tolerance;
- remat keeps fewer saved bytes than no remat (counted by a
  ``saved_tensors_hooks`` around the step);
- under a (4, 1) mesh, ``save_moe``'s recompute makes no route and
  ``nothing``'s re-runs each layer's, counted by the context's
  ``CountingTransport``; without a record of the graph (``no_grad``) and
  with a cache nothing is remat'd.

The reference runs in child processes (``tests/_torch_reference_child.py``).
"""
import numpy as np
import pytest
import torch

from _torch_reference_child import run_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import configs
from repro_torch.core.listrank import sim_mesh
from repro_torch.data import pipeline
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.runtime import context
from repro_torch.train import steps

#: arch -> the ("data", "model") mesh its step runs under (None: none)
ARCHS = {"tinyllama-1.1b": None, "mamba2-130m": None, "hymba-1.5b": None,
         "seamless-m4t-medium": None, "granite-moe-1b-a400m": (4, 1)}
POLICIES = ("nothing", "save_moe", "offload_moe")
BATCH, SEQ = 4, 32
#: gradient parity of a whole train step (tests/test_torch_train.py)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _cfg(arch, **kw):
    return configs.get_config(arch, smoke=True).with_(
        dtype=torch.float32, use_kernels=True, **kw)


def _host_batch(cfg):
    batch = pipeline.global_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH), 0)
    if cfg.family == "encdec":
        batch["enc_embeds"] = np.random.default_rng(1).normal(
            size=(BATCH, SEQ, cfg.prefix_embed_dim)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's parameters, loss and gradients of each arch (no
    mesh: its expert-parallel MoE passes no gradient, ROADMAP queue 3)."""
    jobs = {}
    for arch in ARCHS:
        batch = _host_batch(_cfg(arch))
        enc = batch.pop("enc_embeds", None)
        jobs[arch] = ("loss_grads", (arch, batch, enc))
    return run_reference(jobs, tmp_path_factory.mktemp("remat"), procs=3)


def _step(params, arch, mesh, **kw):
    """(loss, gradient leaves, bytes saved for the backward, the mesh
    transport's collectives) of one ``value_and_grad``."""
    cfg = _cfg(arch, **kw)
    batch = {k: torch.from_numpy(v) for k, v in _host_batch(cfg).items()}
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if mesh is None:
            (loss, _), grads = steps.value_and_grad(params, batch, cfg,
                                                    steps.TrainConfig())
            counts = {}
        else:
            with context.use_mesh(sim_mesh(mesh, ("data", "model"))) as ctx:
                (loss, _), grads = steps.value_and_grad(
                    params, batch, cfg, steps.TrainConfig())
                counts = dict(ctx.transport("cpu").counts)
    return loss, P.leaves(grads), saved[0], counts


@pytest.fixture(scope="module")
def params(ref):
    return {arch: P.from_reference(ref[arch]["params"], _cfg(arch), "cpu")
            for arch in ARCHS}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_gradients_equal_no_remat_for_every_policy(params, arch):
    loss0, g0, _, _ = _step(params[arch], arch, ARCHS[arch], remat=False)
    for policy in POLICIES:
        loss, g, _, _ = _step(params[arch], arch, ARCHS[arch], remat=True,
                              remat_policy=policy)
        assert float(loss) == float(loss0), policy
        assert len(g) == len(g0)
        for i, (a, b) in enumerate(zip(g, g0)):
            assert torch.equal(a, b), (policy, i)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_gradients_equal_the_reference(ref, params, arch):
    """The reference's step runs without a mesh, so the MoE decoder's
    is the dense dispatch there and here."""
    loss, g, _, _ = _step(params[arch], arch, None, remat=True)
    np.testing.assert_allclose(float(loss), ref[arch]["loss"], rtol=1e-5)
    want = P.leaves(P.from_reference(ref[arch]["grads"], _cfg(arch), "cpu"))
    assert len(g) == len(want)
    for i, (a, b) in enumerate(zip(g, want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_saves_fewer_bytes(params, arch):
    _, _, off, _ = _step(params[arch], arch, ARCHS[arch], remat=False)
    _, _, on, _ = _step(params[arch], arch, ARCHS[arch], remat=True)
    assert 0 < on < off, (on, off)


def test_save_moe_recompute_makes_no_route(params):
    """Per layer, the forward's expert-parallel MoE makes 2 all_to_alls
    (there and back) and its backward 2 more; ``nothing``'s recompute
    re-runs both routes, ``save_moe``'s and ``offload_moe``'s none."""
    arch = "granite-moe-1b-a400m"
    layers = _cfg(arch).num_layers
    routes = {}
    for remat, policy in ((False, "nothing"),) + tuple(
            (True, pol) for pol in POLICIES):
        _, _, _, counts = _step(params[arch], arch, ARCHS[arch], remat=remat,
                                remat_policy=policy)
        routes[(remat, policy)] = counts["all_to_all"]
    base = routes[(False, "nothing")]
    assert base == 4 * layers
    assert routes[(True, "nothing")] == base + 2 * layers
    assert routes[(True, "save_moe")] == routes[(True, "offload_moe")] \
        == base


def test_no_remat_without_grad_or_with_a_cache(monkeypatch):
    """``no_grad`` forwards, forwards where nothing requires grad and the
    serving path (prefill with a cache) run no layer under the
    checkpoint; a forward with parameters that require grad runs every
    layer under it."""
    calls = []
    real = M._remat

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(M, "_remat", counted)
    cfg = _cfg("tinyllama-1.1b")
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with torch.no_grad():
        M.forward(params, toks, cfg)
    cache = M.init_cache(cfg, 1, 16, "cpu")
    with torch.enable_grad():
        M.forward(params, toks, cfg)
        params = P.map_tree(lambda a: a.requires_grad_(), params)
        M.prefill(params, toks, cfg, cache)
    assert not calls
    with torch.enable_grad():
        M.forward(params, toks, cfg)
    assert len(calls) == cfg.num_layers
