"""Fault tolerance: supervised step loop with checkpoint/restart,
preemption handling, and straggler detection.

The port's copy of the JAX package's ``repro.runtime.fault_tolerance``.
``Supervisor`` wraps the training loop of ``repro_torch.launch.train``:

  - periodic (async) checkpoints via ``repro_torch.checkpoint``;
  - crash/restart: any exception in a step triggers restore-from-latest
    and replay (the data pipeline is stateless in step, so batches
    regenerate exactly);
  - preemption: SIGTERM/SIGINT set a flag; the loop checkpoints and
    exits cleanly;
  - straggler mitigation: per-step wall times feed a rolling median;
    steps slower than ``straggler_factor``x median are logged and
    counted;
  - failure injection for tests (``inject_failure_at``).

``SolveSupervisor`` does the same for the list-ranking solver's staged
loop (``repro_torch.core.listrank.resume``).

Under a ``torch.distributed`` process group both supervisors are the
group's (``Supervisor(..., ranks=)``, ``SolveSupervisor.bind``): rank 0
writes the checkpoints into a directory every rank sees, the step to
restart from is rank 0's, and every decision that changes what the ranks
run next (a preemption, a failed step, a retry) is agreed over the ranks
with one uncounted reduction, so no rank is left waiting in a collective
that the others skipped.
"""
from __future__ import annotations

import dataclasses
import signal
import tempfile
import time
from collections import deque
from typing import Callable

from repro_torch.checkpoint import Checkpointer
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class SupervisorConfig:
    """``ckpt_dir`` None: the training :class:`Supervisor` keeps no
    checkpoints (a crash replays from the initial state, a preemption
    stops without saving); a :class:`SolveSupervisor` checkpoints into a
    fresh temporary directory."""
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 32
    async_save: bool = True


@dataclasses.dataclass
class SolveSupervisorConfig(SupervisorConfig):
    """Supervisor defaults for the list-ranking solver's staged attempt
    loop: a solve has few (tens of) stage boundaries, so checkpoint at
    every level boundary rather than every 50 training steps."""
    ckpt_every: int = 1


class Preempted(Exception):
    pass


def _any_rank(ranks, flag: bool) -> bool:
    """``flag`` or'd over the ranks of ``ranks`` (its transport's
    ``agree``), or ``flag`` itself for one process."""
    return bool(flag) if ranks is None else ranks.agree([int(flag)])[0] > 0


def _install(handler) -> dict:
    """Point SIGTERM and SIGINT at ``handler``; returns the handlers
    they had, for ``signal.signal`` to put back."""
    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        old[sig] = signal.getsignal(sig)
        signal.signal(sig, handler)
    return old


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, init_state: Callable[[], tuple],
                 restore_like: Callable[[], tuple], device=None, ranks=None):
        """init_state() -> (state, step0) builds fresh state;
        restore_like() -> a template tree (tensors, ``meta`` tensors
        serve) of the checkpoint layout; restored leaves land on
        ``device`` (the template's device when None). ``ranks``: the
        transport of a process group whose ranks each run this loop on the
        same state (the launcher's replicated training): rank 0 writes,
        every rank restarts from rank 0's latest step, and a preemption or
        a failed step on any rank is one on every rank."""
        self.cfg = cfg
        self.ranks = ranks
        self.ckpt = (Checkpointer(cfg.ckpt_dir, keep=cfg.keep,
                                  async_save=cfg.async_save, ranks=ranks)
                     if cfg.ckpt_dir is not None else None)
        self._init_state = init_state
        self._restore_like = restore_like
        self._device = device
        self._preempted = False
        self._times: deque[float] = deque(maxlen=cfg.straggler_window)
        self.stats = {"restarts": 0, "stragglers": 0, "preempted": False,
                      "checkpoints": 0}
        self.inject_failure_at: int | None = None

    def install_signal_handlers(self) -> dict:
        """SIGTERM/SIGINT set the preemption flag. Returns the previous
        handlers (``signal.signal(sig, h)`` for each puts them back)."""
        return _install(self._on_signal)

    def _on_signal(self, *_):
        self._preempted = True

    def _latest(self) -> int | None:
        if self.ckpt is None:
            return None
        # a write still in flight is the latest checkpoint: drain it (and
        # surface its failure) before choosing where to restart from
        self.ckpt.wait()
        return self.ckpt.latest_step()

    def _restore(self):
        return self.ckpt.restore(None, self._restore_like(), self._device)

    def _save(self, step: int, state, blocking: bool = False):
        if self.ckpt is not None:
            self.ckpt.save(step, state, blocking=blocking)
            self.stats["checkpoints"] += 1

    def _start_state(self):
        if self._latest() is not None:
            return self._restore()
        return self._init_state()

    def _note_time(self, dt: float):
        if len(self._times) >= 8:
            med = sorted(self._times)[len(self._times) // 2]
            if dt > self.cfg.straggler_factor * med:
                self.stats["stragglers"] += 1
        self._times.append(dt)

    def run(self, step_fn: Callable, num_steps: int, on_metrics=None):
        """Run ``step_fn(state, step) -> (state, metrics)`` to
        ``num_steps`` with checkpoint/restart supervision. Under a process
        group the preemption flag and each step's outcome are agreed over
        the ranks before they act on them (two uncounted reductions a
        step), and a checkpoint's, which every rank saves together, once
        more."""
        restarts = 0
        state, step = self._start_state()
        while step < num_steps:
            if _any_rank(self.ranks, self._preempted):
                self._save(step, state, blocking=True)
                self.stats["preempted"] = True
                return state, step
            err = None
            try:
                if self.inject_failure_at is not None \
                        and step == self.inject_failure_at:
                    self.inject_failure_at = None
                    raise RuntimeError("injected failure")
                t0 = time.time()
                state, metrics = step_fn(state, step)
                self._note_time(time.time() - t0)
                step += 1
                if on_metrics:
                    on_metrics(step, metrics)
            except Exception as e:
                err = e
            failed = _any_rank(self.ranks, err is not None)
            # a save is a collective under a process group: every rank
            # makes it, once the step's outcome is agreed
            if self.ckpt is not None and not failed and (
                    step % self.cfg.ckpt_every == 0 or step == num_steps):
                try:
                    self._save(step, state)
                except Exception as e:
                    err = e
                failed = _any_rank(self.ranks, err is not None)
            if failed:
                restarts += 1
                self.stats["restarts"] = restarts
                if restarts > self.cfg.max_restarts:
                    raise err if err is not None else RuntimeError(
                        "a step failed on another rank")
                if self._latest() is None:
                    state, step = self._init_state()
                else:
                    state, step = self._restore()
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, step


class SolveSupervisor:
    """The :class:`Supervisor` adapted to the list-ranking solver's
    level-resumable stage loop (``repro_torch.core.listrank.resume``).

    The step loop lives in the solver's stage loop (stages have
    heterogeneous state structures that only it can rebuild); this class
    owns the supervision concerns the stage loop delegates:

      - the :class:`~repro_torch.checkpoint.Checkpointer` (atomic
        keep-k, async) with per-boundary cadence (``cfg.ckpt_every``,
        default every level boundary);
      - SIGTERM/SIGINT preemption flag (``install_signal_handlers`` /
        :attr:`preempted`); the stage loop writes a blocking checkpoint and
        raises :class:`Preempted`;
      - restart accounting (``should_retry``) and straggler detection
        over per-stage wall times;
      - ``stats`` threaded into the solver's ``host_stats["recovery"]``
        (restarts, stragglers, checkpoints, preempted, resumed_from).

    Checkpoints store the boundary state as global (PE-major) host
    arrays plus a manifest ``meta`` (schedule index, per-level capacity
    scales, attempt/escalation path, instance fingerprint) in the JAX
    package's format, so a solve checkpointed by either package resumes
    in the other, on any device.

    Under the ``torch.distributed`` transport every rank builds its own
    supervisor on the same ``ckpt_dir``, one that every rank sees, and the
    solve :meth:`bind` s it to its transport: rank 0 writes the gathered
    boundary, :meth:`latest_meta` is of rank 0's latest step,
    :meth:`should_retry` is rank 0's answer, and :meth:`preempt_agreed`
    is true on every rank when any rank's flag is set.
    """

    def __init__(self, cfg: SupervisorConfig | None = None):
        self.cfg = cfg or SolveSupervisorConfig()
        ckpt_dir = self.cfg.ckpt_dir
        if ckpt_dir is None:
            ckpt_dir = tempfile.mkdtemp(prefix="solve_ckpt_")
        self.ckpt = Checkpointer(ckpt_dir, keep=self.cfg.keep,
                                 async_save=self.cfg.async_save)
        self._preempted = False
        self._restarts = 0
        self._times: deque[float] = deque(maxlen=self.cfg.straggler_window)
        self.stats = {"restarts": 0, "stragglers": 0, "checkpoints": 0,
                      "preempted": 0, "resumed_from": -1}
        #: flight-recorder hook: the solve driver installs its tracer
        #: here so checkpoint save/restore appear in the span tree.
        self.tracer = NULL_TRACER
        #: the transport of the process group the solve runs over (None:
        #: one process); set by :meth:`bind`
        self.ranks = None

    def bind(self, transport) -> None:
        """Supervise a solve whose PEs live on ``transport``'s ranks (the
        stage loop calls this). Over more than one rank the checkpoint
        directory must be given, and be the same one on every rank: a
        temporary one is each rank's own."""
        ranks = transport if transport.world > 1 else None
        if ranks is not None and self.cfg.ckpt_dir is None:
            raise ValueError("a SolveSupervisor over several ranks needs a "
                             "ckpt_dir that every rank sees")
        self.ranks = ranks
        self.ckpt.ranks = ranks

    # ---------------------------------------------------------- signals
    def install_signal_handlers(self) -> dict:
        """SIGTERM/SIGINT set the preemption flag. Returns the previous
        handlers (``signal.signal(sig, h)`` for each puts them back)."""
        return _install(self._on_signal)

    def _on_signal(self, *_):
        self._preempted = True

    def preempt(self):
        """Set the preemption flag (what a SIGTERM does); test hook and
        the target of the ``preempt`` fault injection."""
        self._preempted = True

    @property
    def preempted(self) -> bool:
        """This process's preemption flag."""
        return self._preempted

    def preempt_agreed(self) -> bool:
        """Whether any rank's flag is set (every rank calls it, at the
        same stage boundary); sets this rank's flag when so."""
        self._preempted = _any_rank(self.ranks, self._preempted)
        return self._preempted

    # ------------------------------------------------------ checkpoints
    def boundary(self, idx: int, state, meta: dict, blocking: bool = False):
        """Record a completed stage boundary; checkpoints on the
        ``ckpt_every`` cadence (or unconditionally when blocking).
        ``state``: the checkpoint tree, or a function that makes it,
        called only when a checkpoint is due (on every rank: under a
        process group it gathers the boundary to rank 0)."""
        if blocking or idx % max(self.cfg.ckpt_every, 1) == 0:
            with self.tracer.span(f"ckpt-save@{idx}", cat="checkpoint",
                                  idx=idx, blocking=blocking):
                tree = state() if callable(state) else state
                self.ckpt.save(idx, tree, blocking=blocking, meta=meta)
            self.stats["checkpoints"] += 1

    def latest_meta(self) -> dict | None:
        """The manifest ``meta`` of the latest checkpoint (rank 0's), or
        None."""
        step = self.ckpt.latest_step()
        if step is None:
            return None
        return self.ckpt.manifest(step).get("meta")

    def restore(self, like, device=None):
        with self.tracer.span("ckpt-restore", cat="checkpoint") as sp:
            out = self.ckpt.restore(None, like, device)
            sp.annotate(step=out[1])
            return out

    # ------------------------------------------------------- accounting
    def note_stage_time(self, dt: float):
        if len(self._times) >= 8:
            med = sorted(self._times)[len(self._times) // 2]
            if dt > self.cfg.straggler_factor * med:
                self.stats["stragglers"] += 1
        self._times.append(dt)

    def should_retry(self) -> bool:
        """Account one crash/corruption recovery; False once the restart
        budget is exhausted."""
        self._restarts += 1
        self.stats["restarts"] = self._restarts
        ok = self._restarts <= self.cfg.max_restarts
        if self.ranks is not None:
            ok = bool(self.ranks.from_rank0(int(ok)))
        return ok
