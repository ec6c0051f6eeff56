"""The port's int8 runtime (``repro_torch.runtime.compression``) and
AdamW's int8 state against the JAX package's, on the CPU:

- ``QInt8``'s payload and scales equal the reference's bit for bit over
  seeded shapes (sizes that are not a multiple of the 256-element block,
  all-zero blocks, exact .5 ties, wide ranges), and so do its
  dequantization and ``quantization_error``; the reference runs jitted,
  as its callers run it (``compression``'s docstring says how that
  rounds);
- ``compressed_psum`` over the virtual transport's 8 PEs equals the
  reference's under ``shard_map`` on 8 host devices, four calls with the
  error fed back: the new error bit for bit, the sum within 1e-6
  relative; over ``DistTransport`` at world 2 it equals the virtual
  transport's bit for bit, over every PE and over one mesh axis;
- ``AdamWConfig(state_dtype="int8")`` over 5 steps stays within
  ``tests/test_torch_train.py``'s AdamW tolerances of the reference; its
  checkpoint has the reference's keys (``.q`` and ``.scale``, no
  ``shape``), and each package restores the other's byte for byte;
- under a process group of 2 ranks, ``launch/train.py``'s
  ``Supervisor`` writes one set of step directories (rank 0's), and a
  step that fails on one rank restarts both ranks from the same step.

The reference runs in child processes (``tests/_torch_reference_child.py``)
that see 8 CPU devices; the ranks come from ``tests/_torch_dist_rank.py``.
"""
import os

import numpy as np
import pytest
import torch

from _torch_dist_rank import RankPool
from _torch_reference_child import run_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.listrank import transport as tl
from repro_torch.models.params import map_tree
from repro_torch.optim import adamw
from repro_torch.runtime import compression as C

P = 8
#: sizes that are not, and one that is, a whole number of blocks
SIZES = (1, 255, 256, 700, 1300)
#: the reference's AdamW parity tolerance (tests/test_torch_train.py)
ADAMW_TOL = dict(rtol=2e-6, atol=1e-7)
ADAMW_KW = dict(lr=1e-2, state_dtype="int8", master_weights=True,
                grad_clip=0.5)
STEPS = 5
PSUM_CALLS = 4
SPAWN_S, JOB_S = 120, 120


def _arrays():
    """Seeded inputs: normals at several scales, all-zero blocks, exact
    .5 ties (a block whose absolute maximum is 127, so the payload is the
    value itself), and a tensor of rank 3."""
    rng = np.random.default_rng(23)
    out = []
    for i, n in enumerate(SIZES):
        out.append((rng.normal(size=n) * 10.0 ** (3 * (i % 3) - 3)).astype(
            np.float32))
    z = rng.normal(size=900).astype(np.float32)
    z[256:768] = 0.0                                      # two zero blocks
    out.append(z)
    ties = (rng.integers(-126, 126, 600) + 0.5).astype(np.float32)
    ties[::256] = 127.0
    out.append(ties)
    out.append(rng.normal(size=(3, 5, 7)).astype(np.float32))
    return out


def _opt_tree():
    rng = np.random.default_rng(5)
    return {"w": rng.normal(size=(6, 50)).astype(np.float32),
            "blk": {"a_log": rng.normal(size=(5,)).astype(np.float32),
                    "b": rng.normal(size=(300,)).astype(np.float32)}}


def _grads(vals):
    rng = np.random.default_rng(6)
    return [map_tree(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     vals) for _ in range(STEPS)]


def _psum_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(P, 2, 350)).astype(np.float32)
    x[3] = 0.0                                            # a silent PE
    err = (rng.normal(size=(P, 2, 350)) * 1e-3).astype(np.float32)
    return x, err


def _port_adamw(vals, grads):
    """The port's 5 int8 AdamW steps from float32 params: every step's
    (params, state)."""
    params = map_tree(torch.from_numpy, vals)
    cfg = adamw.AdamWConfig(**ADAMW_KW)
    state = adamw.init(params, cfg)
    out = []
    for g in grads:
        params, state, _ = adamw.update(map_tree(torch.from_numpy, g), state,
                                        params, cfg)
        out.append((params, state))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results of every job of this file, and the port's
    AdamW run with its checkpoint (which the reference restores)."""
    root = tmp_path_factory.mktemp("compression")
    vals = _opt_tree()
    grads = _grads(vals)
    port = _port_adamw(vals, grads)
    ck = Checkpointer(root / "port", async_save=False)
    ck.save(STEPS, port[-1])
    x, err = _psum_inputs()
    out = run_reference({
        "adamw": ("adamw_int8", (vals, grads, ADAMW_KW, str(root / "port"))),
        "psum": ("compressed_psum", (x, err, PSUM_CALLS)),
        "qint8": ("qint8", (_arrays(),))}, root, devices=P, procs=3)
    return {**out, "port": port, "root": root, "vals": vals}


@pytest.fixture(scope="module")
def pool():
    made = RankPool(2, start_timeout=SPAWN_S)
    yield made
    made.close()


# ---------------------------------------------------------------- QInt8
def test_qint8_equals_the_reference_bit_for_bit(ref):
    for x, want in zip(_arrays(), ref["qint8"]):
        q = C.QInt8.quantize(torch.from_numpy(x))
        assert q.shape == want["shape"] == x.shape
        assert q.q.dtype == torch.int8 and q.scale.dtype == torch.float32
        np.testing.assert_array_equal(q.q.numpy(), want["q"])
        assert q.scale.numpy().tobytes() == want["scale"].tobytes()
        assert q.dequantize().numpy().tobytes() == want["deq"].tobytes()
        err = C.quantization_error(torch.from_numpy(x))
        assert err.numpy().tobytes() == want["err"].tobytes()


def test_qint8_zeros_ties_and_blocks():
    """Zeros dequantize to zeros of the shape; a tie rounds to even; a
    zero block has scale 0 and payload 0; padding never reaches the
    values."""
    z = C.QInt8.zeros((3, 5, 7))
    assert z.q.shape == (1, C.BLOCK) and z.scale.shape == (1,)
    assert z.dequantize().shape == (3, 5, 7) and not z.dequantize().any()
    x = torch.tensor([127.0, 2.5, -2.5, 3.5, 0.0])
    q = C.QInt8.quantize(x)
    assert float(q.scale[0]) == np.float32(127.0) * np.float32(1 / 127)
    assert q.q[0, :5].tolist() == [127, 2, -2, 4, 0]
    blocks = torch.zeros(600)
    blocks[300] = 1.0
    q = C.QInt8.quantize(blocks)
    assert q.scale.tolist()[0] == 0.0 and not q.q[0].any()
    assert q.dequantize().shape == (600,)


# ------------------------------------------------------- compressed_psum
def test_compressed_psum_equals_the_reference(ref):
    x, err = _psum_inputs()
    tr = tl.VirtualTransport(("data",), (P,), torch.device("cpu"))
    e = torch.from_numpy(err)
    for i, (want_red, want_err) in enumerate(ref["psum"]):
        red, e = C.compressed_psum(torch.from_numpy(x * (i + 1)), tr, e)
        assert e.numpy().tobytes() == want_err.tobytes(), i
        np.testing.assert_allclose(red.numpy(), want_red, rtol=1e-6,
                                   atol=1e-6 * np.abs(want_red).max())
        # every PE holds the same sum
        assert all(torch.equal(red[0], red[j]) for j in range(P))


def test_compressed_psum_over_two_ranks_equals_the_virtual_transport(pool):
    x, err = _psum_inputs()
    shape, axes = (2, 4), ("data", "model")
    tr = tl.VirtualTransport(axes, shape, torch.device("cpu"))
    for over in (None, ("data",)):
        want = C.compressed_psum(torch.from_numpy(x), tr,
                                 torch.from_numpy(err), over)
        outs = pool.run("compressed_psum", x, err, shape, axes, over,
                        timeout=JOB_S)
        for rank, (red, new) in enumerate(outs):
            rows = slice(rank * 4, rank * 4 + 4)
            assert red.tobytes() == want[0][rows].numpy().tobytes(), over
            assert new.tobytes() == want[1][rows].numpy().tobytes(), over


# ----------------------------------------------------------------- AdamW
def _host(tree):
    """A port (params, state) tree as the reference child returns it:
    numpy leaves, ``QInt8`` as {"q", "scale"}."""
    if isinstance(tree, C.QInt8):
        return {"q": tree.q.numpy(), "scale": tree.scale.numpy()}
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host(v) for v in tree)
    return tree.numpy()


def _dequantized(tree):
    """Every {"q", "scale"} of a host tree dequantized (float32, padded
    to whole blocks)."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return (tree["q"].astype(np.float32) * tree["scale"][:, None]
                ).reshape(-1)
    if isinstance(tree, dict):
        return {k: _dequantized(v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_int8_adamw_matches_the_reference(ref):
    """5 steps given the same gradients: parameters, master copies and
    the dequantized moments within the float32 AdamW tolerances; the
    moments stay int8 blocks."""
    for i, ((params, state), want) in enumerate(zip(ref["port"],
                                                    ref["adamw"]["steps"])):
        got = _host((params, state))
        exp = (want["params"], want["state"])
        assert int(got[1]["step"]) == int(exp[1]["step"]) == i + 1
        assert all(isinstance(q, C.QInt8) for k in ("m", "v")
                   for q in _leaves(state[k]))
        for a, b in zip(_leaves(_dequantized(got)),
                        _leaves(_dequantized(exp))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, **ADAMW_TOL,
                                       err_msg=f"step {i + 1}")


def test_int8_checkpoints_cross_packages(ref):
    """The port's checkpoint of (params, int8 AdamW state) has the
    reference's keys, and each package restores the other's, byte for
    byte."""
    root = ref["root"]
    mine = Checkpointer(root / "port").manifest()["keys"]
    assert mine == ref["adamw"]["keys"]
    assert any(k.endswith("/.q") for k in mine)
    assert any(k.endswith("/.scale") for k in mine)
    assert not any(".shape" in k for k in mine)
    final = _host(ref["port"][-1])
    for a, b in zip(_leaves(ref["adamw"]["restored"]), _leaves(final)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    params = map_tree(lambda a: torch.empty(a.shape, device="meta"),
                      ref["vals"])
    like = (params, adamw.init(params, adamw.AdamWConfig(**ADAMW_KW)))
    got, step = Checkpointer(str(root / "port") + "_ref").restore(None,
                                                                  like)
    assert step == STEPS
    theirs = ref["adamw"]["steps"][-1]
    for a, b in zip(_leaves(_host(got)), _leaves((theirs["params"],
                                                  theirs["state"]))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[1]["m"]["w"].shape == (6, 50)


# ----------------------------------------------- the launcher at world 2
TRAIN = ["--arch", "mamba2-130m", "--smoke", "--steps", "4", "--batch", "2",
         "--seq", "32", "--log-every", "1", "--ckpt-every", "2"]


def test_launcher_checkpoints_once_and_restarts_ranks_together(pool,
                                                               tmp_path):
    """Two ranks on one checkpoint directory: one set of step directories
    (rank 0's writes), the same losses on both ranks; a step that fails
    on rank 1 alone (step index 2, after the step-2 checkpoint) restarts
    both ranks from that checkpoint, and the run ends with the
    uninterrupted run's losses."""
    straight = pool.run("train_launcher", TRAIN + [
        "--ckpt-dir", str(tmp_path / "a")], None, None, timeout=JOB_S)
    losses = [h["loss"] for h in straight[0]["history"]]
    for out in straight:
        assert out["dirs"] == ["step_00000002", "step_00000004"]
        assert out["calls"] == [0, 1, 2, 3]
        assert [h["loss"] for h in out["history"]] == losses
    failed = pool.run("train_launcher", TRAIN + [
        "--ckpt-dir", str(tmp_path / "b")], 1, 3, timeout=JOB_S)
    for out in failed:
        assert out["calls"] == [0, 1, 2, 2, 3]
        assert out["dirs"] == ["step_00000002", "step_00000004"]
        assert [h["loss"] for h in out["history"]] == losses
    assert sorted(os.listdir(tmp_path)) == ["a", "b"]
