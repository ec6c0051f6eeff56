"""Checkpointing: atomic, keep-k, async-capable, restore onto any device.

The port's copy of the JAX package's ``repro.checkpoint.checkpointer``,
over trees of torch tensors, in the same on-disk format: one directory
``step_XXXXXXXX`` per checkpoint holding ``state.npz`` (one array per
leaf, under its tree path) and ``manifest.json`` (``step``, ``keys``,
``time``, ``meta``). Either package restores the other's checkpoints.

Tree paths are the JAX package's: dict keys sorted, sequence indices,
and a dataclass's array fields as ``.name`` in declaration order (its
other fields are static, as a registered pytree's meta fields are, and
so is a field declared with ``metadata={"static": True}``, such as
``QInt8.shape``); ``None`` holds no leaf. bfloat16 leaves, which numpy
cannot hold, are stored as their int16 bits and listed under the
manifest's ``bfloat16``.

Under a process group (``ranks=``, the transport of its ranks) the
checkpoints are the group's: rank 0 alone serialises, publishes and
garbage-collects, the latest step is rank 0's and broadcast, and
:meth:`Checkpointer.wait`, with which every rank's save begins, ends with
a barrier that also carries rank 0's write failure to every rank, so no
rank reads a step still being written and a failed write raises on every
rank.
Every rank reads a restored step itself, so the directory must be one
that every rank sees (one host, or a shared file system).
"""
from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import json
import pathlib
import shutil
import time

import numpy as np
import torch


def _is_node(x) -> bool:
    return (isinstance(x, (torch.Tensor, np.ndarray, dict, list, tuple))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def flatten(tree):
    """(keys, leaves, rebuild): the tree's leaves in the JAX package's
    order with their ``/``-joined paths, and ``rebuild(new_leaves)``,
    which puts new leaves into the same structure."""
    keys, leaves = [], []

    def walk(node, path):
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            names = sorted(node)
            subs = [walk(node[k], path + (str(k),)) for k in names]
            return lambda it: {k: f(it) for k, f in zip(names, subs)}
        if isinstance(node, (tuple, list)):
            subs = [walk(v, path + (str(i),)) for i, v in enumerate(node)]
            kind = type(node)
            return lambda it: kind([f(it) for f in subs])
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            names = [f.name for f in dataclasses.fields(node)
                     if not f.metadata.get("static")
                     and _is_node(getattr(node, f.name))]
            subs = [walk(getattr(node, k), path + ("." + k,)) for k in names]
            return lambda it: dataclasses.replace(
                node, **{k: f(it) for k, f in zip(names, subs)})
        keys.append("/".join(path))
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree, ())
    # walk's closure holds walk itself: drop it, or the cycle keeps every
    # leaf alive until the garbage collector's next full pass
    walk = None
    return keys, leaves, lambda new: build(iter(new))


def _to_host(x) -> np.ndarray:
    """A host copy of one leaf (never a view of a live CPU tensor: the
    writer thread serialises it while the caller goes on)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.empty(0, np.asarray(leaf).dtype)).dtype


def _ran(fn, *args) -> futures.Future:
    """``fn(*args)``, run now, as a finished future of its outcome."""
    done = futures.Future()
    try:
        done.set_result(fn(*args))
    except Exception as e:
        done.set_exception(e)
    return done


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed; carries the failing step."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(
            f"background checkpoint write for step {step} failed: "
            f"{cause!r}")
        self.step = step
        self.__cause__ = cause


class Checkpointer:
    def __init__(self, directory, keep: int = 3, async_save: bool = True,
                 ranks=None):
        """``ranks``: the transport of the process group whose checkpoints
        these are (``world``, ``rank``, ``from_rank0``; see the module
        doc), or None for one process."""
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.ranks = ranks
        self._pool = futures.ThreadPoolExecutor(1) if async_save else None
        self._pending: futures.Future | None = None
        self._pending_step: int | None = None
        #: step -> {"bytes", "snapshot_s", "write_s"} of each save: the
        #: host bytes, the device->host snapshot's seconds, and the
        #: serialisation + publish seconds (set when the write ends)
        self.records: dict[int, dict] = {}
        #: {"step", "bytes", "seconds"} of the last restore (reading and
        #: placing every leaf)
        self.last_restore: dict | None = None

    @property
    def _shared(self) -> bool:
        return self.ranks is not None and self.ranks.world > 1

    @property
    def writes(self) -> bool:
        """Whether this process writes: rank 0 of the group, or the one
        process."""
        return not self._shared or self.ranks.rank == 0

    # ------------------------------------------------------------- save
    def save(self, step: int, state, blocking: bool = False, meta=None):
        """Snapshot ``state`` at ``step``. The device->host copy happens
        synchronously (a consistent snapshot); serialisation runs on the
        background thread unless blocking. ``meta`` (a JSON-able dict) is
        stored in the step's manifest. A failure of the *previous*
        background write surfaces here (or at :meth:`wait`) as
        :class:`CheckpointWriteError` naming the failed step. Under a
        process group every rank calls it at the same step: the write in
        flight is waited for first (:meth:`wait`, so its failure is raised
        on every rank), then rank 0 alone snapshots and writes (the other
        ranks may pass ``state=None``), and a blocking save waits again."""
        sync = blocking or self._pool is None
        if self._shared:
            self.wait()
        if self.writes:
            t0 = time.perf_counter()
            keys, leaves, _ = flatten(state)
            host = [_to_host(x) for x in leaves]
            bf16 = [k for k, x in zip(keys, leaves) if isinstance(
                x, torch.Tensor) and x.dtype == torch.bfloat16]
            self.records[step] = {"bytes": sum(a.nbytes for a in host),
                                  "snapshot_s": time.perf_counter() - t0,
                                  "write_s": None}
            err = self._drain()  # one in flight at a time
            if err is not None:
                raise err
            args = (step, keys, host, meta, bf16)
            if sync and not self._shared:
                self._write(*args)
            else:  # a shared write's outcome reaches every rank at wait
                self._pending_step = step
                self._pending = (_ran(self._write, *args) if sync else
                                 self._pool.submit(self._write, *args))
        if self._shared and sync:
            self.wait()

    def _drain(self) -> CheckpointWriteError | None:
        """Wait for the write in flight; its failure, if it failed."""
        if self._pending is None:
            return None
        pending, step = self._pending, self._pending_step
        self._pending, self._pending_step = None, None
        try:
            pending.result()
        except Exception as e:
            return CheckpointWriteError(step, e)
        return None

    def wait(self):
        """Wait for the write in flight and raise its failure. Under a
        process group every rank calls it: rank 0 drains its write, then
        a barrier carries the outcome, so every rank returns once the
        step is published, or raises ``CheckpointWriteError``."""
        err = self._drain()
        if self._shared:
            failed = self.ranks.from_rank0(0 if err is None else
                                           err.step + 1)
            if failed and err is None:
                raise CheckpointWriteError(failed - 1, RuntimeError(
                    "rank 0's checkpoint write failed"))
        if err is not None:
            raise err

    def _write(self, step, keys, host, meta=None, bf16=()):
        t0 = time.perf_counter()
        tmp = self.dir / f".tmp-{step}-{time.time_ns()}"
        tmp.mkdir()
        np.savez(tmp / "state.npz", **{k: v for k, v in zip(keys, host)})
        manifest = {"step": step, "keys": keys, "time": time.time(),
                    "meta": meta}
        if bf16:
            manifest["bfloat16"] = list(bf16)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc(protect=step)
        self.records[step]["write_s"] = time.perf_counter() - t0

    def _gc(self, protect: int | None = None):
        """Keep the newest ``keep`` checkpoints — but never delete the
        step just written (``protect``): publishing an out-of-order step
        must not gc the checkpoint the caller believes now exists."""
        keep_names = {f"step_{protect:08d}"} if protect is not None else set()
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[:-self.keep]:
            if old.name not in keep_names:
                shutil.rmtree(old, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        """The newest published step, or None; under a process group rank
        0's, on every rank (every rank calls it)."""
        step = None
        if self.writes:
            ckpts = sorted(self.dir.glob("step_*"))
            step = int(ckpts[-1].name.split("_")[1]) if ckpts else None
        if self._shared:
            got = self.ranks.from_rank0(-1 if step is None else step)
            step = None if got < 0 else got
        return step

    def manifest(self, step: int | None = None) -> dict:
        """The manifest dict of ``step`` (latest when None) — includes
        the ``meta`` stored at save time. Lets a restorer read the
        layout parameters before it can build the ``like`` tree."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}" / "manifest.json"
        return json.loads(path.read_text())

    def restore(self, step: int | None, like, device=None):
        """Restore into the structure of ``like`` (a tree of tensors —
        ``meta`` tensors serve as shape-and-dtype templates — or numpy
        arrays). Every leaf takes its template's shape (checked) and
        dtype, and lands on ``device``: by default the template's own
        device, the CPU for a ``meta`` or numpy template. Returns
        (tree, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        t0 = time.perf_counter()
        path = self.dir / f"step_{step:08d}"
        bf16 = set(self.manifest(step).get("bfloat16", ()))
        keys, leaves, rebuild = flatten(like)
        out = []
        with np.load(path / "state.npz") as data:
            for k, leaf in zip(keys, leaves):
                arr = data[k]
                if tuple(arr.shape) != tuple(np.shape(leaf)):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{arr.shape} vs {tuple(np.shape(leaf))}")
                t = torch.from_numpy(arr)
                if k in bf16:
                    t = t.view(torch.bfloat16)
                dev = device
                if dev is None:
                    dev = (leaf.device if isinstance(leaf, torch.Tensor)
                           and leaf.device.type != "meta" else "cpu")
                out.append(t.to(device=dev, dtype=_torch_dtype(leaf)))
        self.last_restore = {"step": step, "bytes": sum(
            x.numel() * x.element_size() for x in out),
            "seconds": time.perf_counter() - t0}
        return rebuild(out), step
