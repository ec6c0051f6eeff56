"""The port's checkpointing and training fault tolerance, as
``tests/test_checkpoint_ft.py`` holds the JAX package's: atomic round
trip, keep-k, async, shape mismatch, and the ``Supervisor``'s completion,
restart, give-up, preemption and straggler cases; the on-disk format is
the reference's (each package restores the other's checkpoints); and
``launch/train.py --ckpt-dir``, crashed and resumed, ends bit-equal to an
uninterrupted run on the CPU."""
import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.core.listrank.store import Store
from repro_torch.launch import train as train_launch
from repro_torch.runtime.fault_tolerance import Supervisor, SupervisorConfig

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _state(val=0.0):
    return {"params": {"w": torch.full((8,), val, dtype=torch.float32),
                       "b": torch.arange(4, dtype=torch.int32)},
            "opt": {"m": torch.zeros(8, dtype=torch.float32)}}


def _like(tree):
    _, leaves, rebuild = flatten(tree)
    return rebuild([torch.empty_like(x, device="meta") for x in leaves])


def _assert_trees_equal(a, b):
    ka, la, _ = flatten(a)
    kb, lb, _ = flatten(b)
    assert ka == kb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    st = _state(3.5)
    ck.save(7, st)
    restored, step = ck.restore(None, _like(st))
    assert step == 7
    _assert_trees_equal(st, restored)
    assert ck.records[7]["bytes"] == 8 * 4 + 4 * 4 + 8 * 4


def test_keep_k_and_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(float(s)))
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_00000003", "step_00000004"]
    assert ck.latest_step() == 4


def test_async_save_then_restore(tmp_path):
    ck = Checkpointer(tmp_path, async_save=True)
    ck.save(1, _state(1.0))
    ck.wait()
    assert ck.latest_step() == 1
    assert ck.records[1]["write_s"] is not None


def test_async_snapshot_is_taken_at_save(tmp_path):
    """A CPU tensor changed in place after ``save`` returns does not
    reach the checkpoint: the snapshot is a copy, not a view."""
    ck = Checkpointer(tmp_path, async_save=True)
    st = _state(1.0)
    ck.save(1, st)
    st["params"]["w"].fill_(9.0)
    ck.wait()
    restored, _ = ck.restore(1, _like(st))
    assert torch.equal(restored["params"]["w"], torch.full((8,), 1.0))


def test_restore_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(1, _state())
    bad = {"params": {"w": torch.empty(9, device="meta"),
                      "b": torch.empty(4, dtype=torch.int32, device="meta")},
           "opt": {"m": torch.empty(8, device="meta")}}
    with pytest.raises(ValueError):
        ck.restore(None, bad)


def test_tree_paths_dtypes_and_bfloat16(tmp_path):
    """Store fields as ``.name`` in declaration order (``dense`` is
    static), sorted dict keys, sequence indices; bfloat16 round-trips
    through its bits; a numpy template restores too."""
    st = {"z": (Store(ids=torch.arange(3, dtype=torch.int32),
                      succ=torch.zeros(3, dtype=torch.int32),
                      rank=torch.ones(3), valid=torch.ones(3, dtype=bool),
                      dense=True),),
          "a": torch.randn(5).to(torch.bfloat16), "n": None}
    keys, _, _ = flatten(st)
    assert keys == ["a", "z/0/.ids", "z/0/.succ", "z/0/.rank", "z/0/.valid"]
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(3, st)
    assert ck.manifest(3)["bfloat16"] == ["a"]
    restored, _ = ck.restore(3, _like({k: v for k, v in st.items()
                                       if k != "n"}) | {"n": None})
    assert restored["n"] is None and restored["z"][0].dense
    _assert_trees_equal({k: v for k, v in st.items() if k != "n"},
                        {k: v for k, v in restored.items() if k != "n"})
    arr, _ = ck.restore(3, {"z": (Store(ids=np.zeros(3, np.int32),
                                        succ=np.zeros(3, np.int32),
                                        rank=np.zeros(3, np.float32),
                                        valid=np.zeros(3, bool)),),
                            "a": torch.empty(5, dtype=torch.bfloat16)})
    assert arr["z"][0].ids.dtype == torch.int32
    assert torch.equal(arr["a"].view(torch.int16), st["a"].view(torch.int16))


def test_flatten_and_save_keep_no_leaf_alive(tmp_path):
    """Once the caller drops the tree, the leaves that ``flatten`` and a
    blocking ``save`` saw are freed at once, not at the garbage
    collector's next pass (a reference cycle kept a whole optimizer
    state alive on the card)."""
    import gc
    import weakref
    leaf = torch.zeros(1000)
    tree = {"a": leaf, "b": [torch.ones(3)],
            "s": Store(ids=torch.arange(3, dtype=torch.int32),
                       succ=torch.zeros(3, dtype=torch.int32),
                       rank=torch.ones(3), valid=torch.ones(3, dtype=bool))}
    alive = weakref.ref(leaf)
    del leaf
    gc.disable()
    try:
        flatten(tree)
        Checkpointer(tmp_path, async_save=False).save(1, tree)
        del tree
        assert alive() is None
    finally:
        gc.enable()


def test_checkpoints_cross_frameworks(tmp_path):
    """The JAX package's Checkpointer restores a port checkpoint, and the
    port's restores a JAX one, with equal keys, bytes and dtypes."""
    st = _state(2.25)
    Checkpointer(tmp_path / "port", async_save=False).save(4, st, meta={
        "k": 1})
    like_j = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), jnp.dtype(str(x.dtype).removeprefix("torch."))),
        {k: dict(v) for k, v in st.items()})
    ck_j = JaxCheckpointer(tmp_path / "port", async_save=False)
    got_j, step = ck_j.restore(None, like_j)
    assert step == 4 and ck_j.manifest()["meta"] == {"k": 1}
    for a, b in zip(jax.tree.leaves(got_j), flatten(st)[1]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    src = {"params": {"w": jnp.full((8,), 1.5, jnp.float32),
                      "b": jnp.arange(4, dtype=jnp.int32)},
           "opt": {"m": jnp.ones((8,), jnp.float32)}}
    JaxCheckpointer(tmp_path / "jax", async_save=False).save(2, src)
    got, _ = Checkpointer(tmp_path / "jax").restore(None, _like(_state()))
    assert json.loads((tmp_path / "jax" / "step_00000002" / "manifest.json"
                       ).read_text())["keys"] == flatten(got)[0]
    for a, b in zip(jax.tree.leaves(src), flatten(got)[1]):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()


# ------------------------------------------------------- supervisor
def _mk_supervisor(tmp_path, **kw):
    def init_state():
        return {"x": torch.zeros((), dtype=torch.float32)}, 0

    def restore_like():
        return {"x": torch.empty((), device="meta")}

    cfg = SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                           async_save=False, **kw)
    return Supervisor(cfg, init_state, restore_like)


def test_supervisor_completes_and_checkpoints(tmp_path):
    sup = _mk_supervisor(tmp_path)

    def step_fn(state, step):
        return {"x": state["x"] + 1}, {"loss": float(step)}

    state, step = sup.run(step_fn, 12)
    assert step == 12
    assert float(state["x"]) == 12
    assert sup.stats["checkpoints"] >= 2


def test_supervisor_restarts_after_crash(tmp_path):
    sup = _mk_supervisor(tmp_path)
    sup.inject_failure_at = 8

    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}, {}

    state, step = sup.run(step_fn, 12)
    assert step == 12
    assert sup.stats["restarts"] == 1
    # steps 5..7 replayed after restoring the step-5 checkpoint
    assert calls.count(5) == 2 and calls.count(6) == 2
    assert float(state["x"]) == 12  # state identical to no-crash run


def test_supervisor_restores_a_checkpoint_still_being_written(
        tmp_path, monkeypatch):
    """A step that fails while the last checkpoint's write is in flight
    restarts from that checkpoint, not from an older one or step 0."""
    savez = np.savez

    def slow_savez(*a, **kw):
        time.sleep(0.3)
        savez(*a, **kw)

    monkeypatch.setattr(np, "savez", slow_savez)
    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
                     lambda: ({"x": torch.zeros(())}, 0),
                     lambda: {"x": torch.empty((), device="meta")})
    sup.inject_failure_at = 5
    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}, {}

    state, step = sup.run(step_fn, 7)
    assert (step, float(state["x"])) == (7, 7)
    assert calls == [0, 1, 2, 3, 4, 5, 6]
    assert sup.ckpt.last_restore["step"] == 5


def test_supervisor_without_a_directory_replays_from_the_start():
    sup = Supervisor(SupervisorConfig(ckpt_every=5),
                     lambda: ({"x": torch.zeros(())}, 0), lambda: None)
    sup.inject_failure_at = 8
    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}, {}

    state, step = sup.run(step_fn, 12)
    assert (step, float(state["x"])) == (12, 12)
    assert calls.count(0) == 2 and sup.stats["checkpoints"] == 0


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup = _mk_supervisor(tmp_path, max_restarts=1)

    def step_fn(state, step):
        raise RuntimeError("permafail")

    with pytest.raises(RuntimeError):
        sup.run(step_fn, 4)


def test_supervisor_preemption_saves(tmp_path):
    sup = _mk_supervisor(tmp_path)

    def step_fn(state, step):
        if step == 3:
            sup._preempted = True  # simulate SIGTERM mid-run
        return {"x": state["x"] + 1}, {}

    state, step = sup.run(step_fn, 100)
    assert sup.stats["preempted"]
    assert step == 4
    # a fresh supervisor resumes from the preemption checkpoint
    sup2 = _mk_supervisor(tmp_path)
    state2, step2 = sup2.run(lambda s, i: ({"x": s["x"] + 1}, {}), 6)
    assert step2 == 6
    assert float(state2["x"]) == 6


def test_straggler_detection(tmp_path):
    sup = _mk_supervisor(tmp_path)

    def step_fn(state, step):
        if step == 10:
            time.sleep(0.25)
        else:
            time.sleep(0.005)
        return state, {}

    sup.run(step_fn, 12)
    assert sup.stats["stragglers"] >= 1


# ------------------------------------------------ the training entry
TRAIN = ["--arch", "mamba2-130m", "--smoke", "--steps", "6", "--batch", "2",
         "--seq", "32", "--log-every", "1", "--device", "cpu",
         "--ckpt-every", "2"]


def _final(directory):
    with np.load(os.path.join(directory, "step_00000006", "state.npz")) as z:
        return {k: z[k] for k in z.files}


class _Killed(BaseException):
    """Stands in for the process dying: not an ``Exception``, so the
    supervisor does not catch it."""


@pytest.mark.parametrize("how", ["in_process", "killed"])
def test_train_crash_and_resume_is_bit_equal(tmp_path, monkeypatch, how):
    """A run whose step index 3 fails (an exception the supervisor
    restores from the step-2 checkpoint, or the process dying and the run
    started again on its directory) ends with the uninterrupted run's
    final state, bit for bit."""
    straight = train_launch.main(TRAIN + ["--ckpt-dir", str(tmp_path / "a")])
    real = train_launch.train_steps.train_step
    calls = []
    crash = RuntimeError if how == "in_process" else _Killed

    def failing(params, opt, *a, **kw):
        calls.append(int(opt["step"]))
        if len(calls) == 4:
            raise crash()
        return real(params, opt, *a, **kw)

    monkeypatch.setattr(train_launch.train_steps, "train_step", failing)
    if how == "in_process":
        hist = train_launch.main(TRAIN + ["--ckpt-dir", str(tmp_path / "b")])
        assert calls == [0, 1, 2, 3, 2, 3, 4, 5]
    else:
        # blocking saves: the dead run's writes have all landed
        monkeypatch.setattr(train_launch, "SupervisorConfig",
                            functools.partial(SupervisorConfig,
                                              async_save=False))
        with pytest.raises(_Killed):
            train_launch.main(TRAIN + ["--ckpt-dir", str(tmp_path / "b")])
        monkeypatch.setattr(train_launch.train_steps, "train_step", real)
        assert sorted(os.listdir(tmp_path / "b")) == ["step_00000002"]
        hist = train_launch.main(TRAIN + ["--ckpt-dir", str(tmp_path / "b")])
        assert [h["step"] for h in hist] == [3, 4, 5, 6]
    a, b = _final(tmp_path / "a"), _final(tmp_path / "b")
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert hist[-1]["loss"] == straight[-1]["loss"]
