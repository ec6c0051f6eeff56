"""The port's mesh context (``runtime.context``) and expert-parallel MoE
(``layers.moe_ffn_ep``) against the JAX package's, at the SMOKE configs
of granite-moe-1b and kimi-k2 (which has a shared expert) in float32.

The reference runs in child processes (``_torch_reference_child.py``)
whose jax sees 4 CPU devices, so its ``shard_map`` runs on real meshes;
the port runs on its virtual-PE transport. Both take the same MoE
weights (the port's ``M.init``, seed 0, as numpy) and the same ``x`` of
(4, 16, d_model):

- ``moe_ffn`` under a ("data", "model") mesh of (1, 1), (4, 1) and
  (2, 2) equals the reference's ``moe_ffn_ep`` at capacity factors 1
  (assignments dropped, recounted in numpy) and 8 (none dropped), output
  and aux within 1e-5; with no drops it equals ``_moe_ffn_dense``;
- its gradients equal those of the reference's ``_moe_ffn_dense``
  within ``GRAD_TOL``, while the reference's ``moe_ffn_ep`` passes none
  (its wire bit-casts every leaf to int32);
- the wire carries bfloat16 and float16 bit for bit, where the
  reference raises ``TypeError``;
- ``psum_axes`` on the virtual transport, ``use_mesh`` / ``current``,
  the dispatcher's fallback;
- one ``train_step`` of each model under a (1, 1) context, from the
  reference's weights (``params.from_reference``): the loss and aux of
  the reference's under its (1, 1) mesh, the updated parameters of the
  reference's without a mesh (its mesh update leaves the experts
  untrained); the training entry point takes ``moe_ffn_ep``.

The world-2 ``DistMesh`` run is in ``tests/test_torch_dist.py``.
"""
import numpy as np
import pytest
import torch

from _torch_reference_child import run_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import configs
from repro_torch.core.listrank import exchange, sim_mesh
from repro_torch.core.listrank import transport as tl
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.optim import adamw
from repro_torch.runtime import context
from repro_torch.train import steps

ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
SHAPES = [(1, 1), (4, 1), (2, 2)]
FACTORS = [1.0, 8.0]
AXES = ("data", "model")
#: float32 parity of one layer: sums over other orders than XLA's
TOL = dict(atol=1e-5, rtol=1e-5)
#: gradient parity, as tests/test_torch_train.py
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
#: the train step's data: batch, sequence length
BATCH, SEQ = 2, 32


def _cfg(arch, cf=None):
    cfg = configs.get_config(arch, smoke=True)
    return cfg if cf is None else cfg.with_(capacity_factor=cf)


def _ffn(arch):
    """The first layer's MoE weights of the port's SMOKE ``M.init``
    (seed 0), as numpy."""
    params = M.init(_cfg(arch), torch.Generator().manual_seed(0), "cpu")

    def first(t):
        return ({k: first(v) for k, v in t.items()} if isinstance(t, dict)
                else t[0].numpy())
    return first(params["layers"]["ffn"])


def _x(arch):
    return np.random.default_rng(7).normal(
        size=(4, 16, _cfg(arch).d_model)).astype(np.float32)


def _batch(arch):
    return pipeline.global_batch(pipeline.DataConfig(
        vocab_size=_cfg(arch).vocab_size, seq_len=SEQ, global_batch=BATCH), 0)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference result of this file, from four children at once
    (the longest jobs first: a train step under the mesh, then each
    mesh's layer)."""
    jobs = {("train", arch, True): ("moe_train_step",
                                    (arch, _batch(arch), True))
            for arch in ARCHS}
    for arch in ARCHS:
        for shape in SHAPES:
            jobs[("ep", arch, shape)] = ("moe_layer_ep", (
                arch, _ffn(arch), _x(arch), shape, FACTORS))
    for arch in ARCHS:
        jobs[("dense", arch)] = ("moe_layer_dense",
                                 (arch, _ffn(arch), _x(arch), FACTORS, (4, 1)))
        jobs[("train", arch, False)] = ("moe_train_step",
                                        (arch, _batch(arch), False))
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), devices=4,
                         procs=4)


def _tensors(t, grad=False):
    return ({k: _tensors(v, grad) for k, v in t.items()} if isinstance(t, dict)
            else torch.from_numpy(np.array(t)).requires_grad_(grad))


def _leaves(p, x):
    """{name: tensor} of the weights (``shared.*`` for the shared
    expert's) and ``x``."""
    out = {"x": x}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update({f"shared.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _run(arch, cf, shape=None, dtype=torch.float32, grad=False):
    """The port's ``moe_ffn`` under a mesh context of ``shape`` (none:
    ``_moe_ffn_dense``): (y, aux, counts, {name: gradient of sum(y * y)})."""
    cfg = _cfg(arch, cf)
    p = _tensors(_ffn(arch), grad)
    if dtype != torch.float32:
        p = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(
            v, dict) else v if k == "router" else v.to(dtype))
            for k, v in p.items()}
    x = torch.from_numpy(_x(arch)).to(dtype).requires_grad_(grad)
    counts, grads = {}, {}
    if shape is None:
        y, aux = L._moe_ffn_dense(p, x, cfg)
    else:
        with context.use_mesh(sim_mesh(shape, AXES)) as ctx:
            y, aux = L.moe_ffn(p, x, cfg)
            counts = dict(ctx.transport(x.device).counts)
    if grad:
        leaves = _leaves(p, x)
        grads = dict(zip(leaves, torch.autograd.grad(
            (y * y).sum(), list(leaves.values()))))
    return y.detach(), float(aux.detach()), counts, grads


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_matches_the_reference(ref, arch, shape, cf):
    y, aux, counts, _ = _run(arch, cf, shape)
    want_y, want_aux = ref[("ep", arch, shape)][cf]
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(aux, want_aux, **TOL)
    # two routes (one all_to_all each: one hop, packed wire; none where
    # the expert axis is one PE), the aux loss's mean over the batch axes
    # and the sum over the tensor axis
    routes = {"all_to_all": 2} if shape[0] > 1 else {}
    assert counts == {**routes, "psum": 2}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_equals_the_dense_dispatch_without_drops(ref, arch, shape):
    y, aux, _, _ = _run(arch, 8.0, shape)
    y_dense, aux_dense, _, _ = _run(arch, 8.0)
    np.testing.assert_allclose(y.numpy(), y_dense.numpy(), **TOL)
    np.testing.assert_allclose(y.numpy(),
                               ref[("dense", arch)]["dense"][8.0][0], **TOL)
    if shape == (1, 1):  # one PE runs the dense dispatch's arithmetic
        assert torch.equal(y, y_dense) and aux == aux_dense


def _loads(arch):
    """numpy's recount of the assignments per expert: (loads over the
    whole batch, loads per (4, 1) shard), from a stable descending sort
    of the router's softmax."""
    cfg, ffn = _cfg(arch), _ffn(arch)
    xf = _x(arch).reshape(-1, cfg.d_model).astype(np.float64)
    logits = xf @ ffn["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.top_k]
    whole = np.bincount(top.ravel(), minlength=cfg.num_experts)
    shards = [np.bincount(t.ravel(), minlength=cfg.num_experts)
              for t in np.split(top, 4)]
    return cfg, whole, shards


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_factor_one_drops_and_eight_does_not(ref, arch):
    cfg, whole, shards = _loads(arch)
    e, n_k = cfg.num_experts, int(whole.sum())
    cap = {cf: max(8, int(cf * n_k / e)) for cf in FACTORS}
    assert whole.max() > cap[1.0] and whole.max() <= cap[8.0]
    # at (4, 1) a shard's mailbox to each expert PE holds all it sends,
    # and an expert PE keeps cap[cf] assignments an expert: the same drops
    q, e_loc = n_k // 4, e // 4
    cap_send = min(q, int(q / 4 + 5 * (q / 4) ** 0.5) + 8)
    assert max(s.reshape(4, e_loc).sum(1).max() for s in shards) <= cap_send
    assert all(max(8, int(cf * q / e_loc)) == cap[cf] for cf in FACTORS)
    for shape in ((1, 1), (4, 1)):
        one, eight = (ref[("ep", arch, shape)][cf][0] for cf in FACTORS)
        assert np.abs(one - eight).max() > 1e-3


# ------------------------------------------------------------ bfloat16
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_float_wire_round_trips_every_bit_pattern(dtype):
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).reshape(2, -1)
    leaf = bits.view(dtype)             # NaNs and infinities included
    word = exchange.to_wire_word(leaf)
    assert word.dtype == torch.int32
    assert torch.equal(exchange.from_wire_word(word, dtype).view(torch.int16),
                       bits)
    payload = {"h": leaf[..., None].expand(2, leaf.shape[1], 3),
               "i": bits.to(torch.int32)}
    wf = exchange.WireFormat.from_payload(payload)
    assert wf.width == 3 + 1 + 1        # one word an element, and validity
    valid = torch.ones(bits.shape, dtype=torch.bool)
    got, got_valid = wf.unpack_cols(wf.planes(payload, valid))
    assert torch.equal(got["h"].view(torch.int16),
                       payload["h"].view(torch.int16))
    assert torch.equal(got["i"], payload["i"]) and bool(got_valid.all())


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_one_pe_hop_delivers_the_wires_result(shape):
    """``route_differentiable`` over an expert axis of one PE scatters each
    leaf to its mailbox slot with no wire: bit for bit what
    ``exchange.route``'s packed wire and all_to_all deliver, with messages
    dropped at the mailbox's capacity and invalid ones skipped; a float
    leaf's gradient is the cotangent at its slot, zero where it did not
    ship, and no collective runs either way."""
    rng = np.random.default_rng(5)
    with context.use_mesh(sim_mesh(shape, AXES)) as ctx:
        tr = ctx.transport("cpu")
        plan = exchange.MeshPlan.from_mesh(
            ctx.mesh, ("data",), L.IndirectionSpec.direct(("data",)),
            transport=tr)
        p, q, cap = tr.p_local, 24, 16
        valid = torch.from_numpy(rng.random((p, q)) < 0.8)
        payload = {
            "f": torch.from_numpy(rng.normal(size=(p, q, 3)).astype(
                np.float32)).requires_grad_(),
            "h": torch.from_numpy(rng.normal(size=(p, q))).to(torch.bfloat16),
            "i": torch.from_numpy(rng.integers(-9, 9, (p, q)).astype(
                np.int32))}
        dest = tr.axis_index()[:, None].expand(p, q)
        got, got_valid = exchange.route_differentiable(plan, cap, payload,
                                                       dest, valid)
        assert not tr.counts
        want, want_valid, _, _ = exchange.route(
            plan, [cap], {k: v.detach() for k, v in payload.items()}, dest,
            valid)
        assert tr.counts == {"all_to_all": 1}
        assert torch.equal(got_valid, want_valid)
        for k in payload:
            assert got[k].dtype == want[k].dtype
            assert got[k].detach().contiguous().view(torch.uint8).equal(
                want[k].contiguous().view(torch.uint8)), k
        ct = torch.from_numpy(rng.normal(size=(p, cap, 3)).astype(np.float32))
        grad, = torch.autograd.grad((got["f"] * ct).sum(), payload["f"])
    assert tr.counts == {"all_to_all": 1}
    # message i of a PE ships to slot (valid messages before it) if it fits
    slot = np.cumsum(valid.numpy(), 1) - 1
    ships = valid.numpy() & (slot < cap)
    assert (~ships & valid.numpy()).any()          # some are dropped
    want_grad = np.where(ships[..., None], np.take_along_axis(
        ct.numpy(), np.clip(slot, 0, cap - 1)[..., None], 1), 0)
    np.testing.assert_array_equal(grad.numpy(), want_grad)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_ep_rejects_bfloat16(ref, arch):
    """The reference's wire raises for bfloat16 payloads, so its
    ``moe_ffn_ep`` cannot run a full-width (bfloat16) MoE model; the
    port's runs, and on one PE equals its dense dispatch bit for bit."""
    assert ref[("dense", arch)]["bf16_error"] == \
        "wire format does not support dtype bfloat16"
    y, aux, _, _ = _run(arch, 8.0, (1, 1), torch.bfloat16)
    y_dense, aux_dense, _, _ = _run(arch, 8.0, None, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y_dense) and aux == aux_dense
    y22, _, _, _ = _run(arch, 8.0, (2, 2), torch.bfloat16)
    np.testing.assert_allclose(y22.float().numpy(), y_dense.float().numpy(),
                               atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_gradients_equal_the_reference_dense_dispatchs(ref, arch, shape):
    """At capacity factor 8 (nothing dropped), every gradient of
    ``sum(y * y)`` through the port's ``moe_ffn_ep`` equals the one
    through the reference's ``_moe_ffn_dense``."""
    _, _, _, grads = _run(arch, 8.0, shape, grad=True)
    g_p, g_x = ref[("dense", arch)]["grad_dense"]
    want = _leaves(g_p, g_x)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL,
                                   err_msg=name)
        assert np.abs(want[name]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_ep_gradients_are_zero(ref, arch):
    """The reference's route bit-casts every leaf to int32 and back, so
    no gradient reaches the experts, the router or x (but through a
    shared expert, whose path does not cross the wire) through its
    ``moe_ffn_ep``: a fault of the reference the port does not copy.
    This fails once the reference is repaired."""
    g_p, g_x = ref[("dense", arch)]["grad_ep"]
    zero = ["router", "w_gate", "w_up", "w_down"]
    if "shared" not in g_p:
        zero.append("x")
    got = _leaves(g_p, g_x)
    for name in zero:
        assert np.abs(got[name]).max() == 0.0, name


# ------------------------------------------------ transport and context
def test_psum_axes_on_the_virtual_transport():
    sizes = (2, 3, 2)
    tr = tl.CountingTransport(tl.VirtualTransport(
        ("a", "b", "c"), sizes, torch.device("cpu")))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 4)).astype(np.float32)
    grid = x.reshape(sizes + (4,))
    for axes in [(), ("a",), ("b",), ("c",), ("a", "c"), ("a", "b", "c")]:
        dims = tuple("abc".index(a) for a in axes)
        want = np.broadcast_to(grid.sum(dims, keepdims=True), grid.shape)
        got = tr.psum_axes(torch.from_numpy(x), axes)
        np.testing.assert_allclose(got.numpy(), want.reshape(12, 4),
                                   rtol=1e-6)
    big = torch.full((12,), 2 ** 30, dtype=torch.int32)
    got = tr.psum_axes(big, ("b",))     # an int32 sum wraps
    assert got.dtype == torch.int32 and int(got[0]) == -(2 ** 30)
    assert tr.counts == {"psum": 7}
    with pytest.raises(ValueError):
        tr.psum_axes(big, ("d",))      # not an axis of the mesh


def test_use_mesh_nests_and_resets():
    assert context.current() is None
    outer = sim_mesh((2, 2), AXES)
    with context.use_mesh(outer) as ctx:
        assert context.current() is ctx and ctx.mesh is outer
        assert (ctx.dp_axes, ctx.ep_axis, ctx.tp_axis) == (
            ("data",), "data", "model")
        assert ctx.all_axes == AXES
        inner = sim_mesh((2, 4), ("pod", "x"))
        with context.use_mesh(inner) as ctx2:
            # no "data" axis: experts on the last axis; no "model": no tp
            assert (ctx2.dp_axes, ctx2.ep_axis, ctx2.tp_axis) == (
                ("pod",), "x", None)
            assert context.current() is ctx2
        assert context.current() is ctx
        with pytest.raises(RuntimeError):
            with context.use_mesh(sim_mesh(3), dp_axes=("pe",)):
                raise RuntimeError("reset on the way out")
        assert context.current() is ctx
    assert context.current() is None


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatcher_takes_the_dense_dispatch_when_experts_do_not_split(arch):
    """8 experts over an expert axis of 3: the single-program dispatch,
    as the reference's dispatcher, and no collective."""
    cfg = _cfg(arch)
    p = _tensors(_ffn(arch))
    x = torch.from_numpy(_x(arch))
    with context.use_mesh(sim_mesh((3, 1), AXES)) as ctx:
        y, aux = L.moe_ffn(p, x, cfg)
        assert not ctx.transport("cpu").counts
    want, want_aux = L._moe_ffn_dense(p, x, cfg)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_under_the_mesh_matches_the_reference(ref, arch):
    """One ``train_step`` under a (1, 1) context from the reference's
    weights: the loss and aux loss of the reference's under its (1, 1)
    mesh context, and the parameters of the reference's without one (its
    dense dispatch, the same function at (1, 1)): the port's experts and
    router train, the reference's mesh run leaves them untouched by the
    loss."""
    cfg = _cfg(arch)
    mesh_run, dense_run = ref[("train", arch, True)], ref[("train", arch,
                                                              False)]
    params = P.from_reference(mesh_run["params"], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    tcfg = steps.TrainConfig()
    with context.use_mesh(sim_mesh((1, 1), AXES)) as ctx:
        new, _, metrics = steps.train_step(params, adamw.init(
            params, tcfg.optimizer), batch, cfg, tcfg)
        # the forward's two sums a layer, and the first of them again in
        # the layer's remat recompute (cfg.remat, policy "nothing", as the
        # reference's), which stops after the last tensor the backward
        # needs, before the tensor axis's sum; the routes and their
        # transposes in the backward cross a one-PE hop, with no collective
        assert ctx.transport("cpu").counts == {"psum": 3 * cfg.num_layers}
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k]),
                                   mesh_run["metrics"][k], rtol=1e-5)
    want = P.from_reference(dense_run["new"], cfg, "cpu")
    for i, (a, b) in enumerate(zip(P.leaves(new), P.leaves(want))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL,
                                   err_msg=f"leaf {i}")


def test_train_entry_point_takes_moe_ffn_ep(monkeypatch):
    """``launch/train.py --arch granite-moe-1b-a400m --smoke`` runs every
    MoE layer through ``moe_ffn_ep`` under its (1, 1) mesh: the
    context's transport counts two sums a layer call (the aux loss's
    mean and the tensor axis's sum; the routes cross a one-PE hop with
    no collective), where the dense dispatch counts none."""
    calls = []
    real = L.moe_ffn_ep

    def counted(p, x, cfg, ctx):
        tr = ctx.transport(x.device)
        before = dict(tr.counts)
        out = real(p, x, cfg, ctx)
        calls.append((ctx.mesh.axis_sizes, {
            k: v - before.get(k, 0) for k, v in tr.counts.items()}))
        return out
    monkeypatch.setattr(L, "moe_ffn_ep", counted)
    history = train_launch.main([
        "--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "2",
        "--batch", str(BATCH), "--seq", str(SEQ), "--log-every", "1",
        "--device", "cpu"])
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    layers = configs.get_config("granite-moe-1b-a400m", smoke=True).num_layers
    assert calls == [((1, 1), {"psum": 2})] * (2 * layers)
