"""Deterministic interleaving model checker core (loom-lite).

Chaos runs sample schedules; this module *enumerates* them.  A
:class:`Runner` executes a scripted scenario's tasks on real threads but
cooperatively: exactly one task runs at a time, and control returns to
the scheduler at every **yield point** — TrackedLock / TrackedCondition
acquire and release, ``sync_probe`` sites, and explicit
``sanitize.yield_point(tag)`` calls on the serve plane's protocol
boundaries (journal replay, ack boundaries, ring-view scans).  Because
the scheduler never runs a task whose next lock is owned by another
task, the underlying acquires never block, so a *schedule* — the list
of "which ready task goes next" decisions — fully determines the
execution.  An :class:`Explorer` then walks the schedule tree
depth-first: run once following defaults, and for every decision point
branch into each not-taken alternative whose pending action could have
*conflicted* with the chosen one (DPOR-lite — independent actions
commute, so permuting them cannot change any reachable state and the
branch is pruned).  Conflicts are judged by resource family (the first
dotted component of the yield tag or lock name), deliberately coarse:
``journal.replay`` and ``journal.lock`` conflict even though one is a
file read and the other a mutex, because they meet at the journal file.

Virtual time: ``Runner.clock`` counts scheduling steps; scenarios that
need timestamps read it instead of the wall clock, so a schedule replays
bit-identically.

Supported scenario shape: tasks that run to completion through lock
regions and yield points.  ``Condition.wait`` is rejected with a clear
error — a parked waiter needs a notion of notify-edges this model
doesn't have (scenarios drive schedulers with ``start=False`` and never
park).  Deadlock (no runnable task, live tasks remain) is detected,
reported as a violation, and the run is aborted by raising
:class:`TaskAbort` through every parked task so no threads leak.

Stdlib-only, import-cheap; the only repo import is ``utils.sanitize``
for hook installation.  Port of ``consensuscruncher_tpu/utils/
interleave.py``, line for line: the port's yield points are the
reference's three (``journal.replay``, ``serve.ack``, ``ringview.scan``)
plus its tracked locks and ``sync_probe`` sites.
"""

from __future__ import annotations

import random
import threading

from . import sanitize


class InterleaveError(RuntimeError):
    """Scenario used an operation the cooperative model cannot schedule."""


class TaskAbort(BaseException):
    """Raised inside parked tasks to unwind an abandoned run.  Derives
    from BaseException so scenario-level ``except Exception`` handlers
    (retry loops, error replies) cannot swallow the unwind."""


def _family(resource: str) -> str:
    return resource.split(".", 1)[0]


class _Task:
    __slots__ = ("name", "fn", "thread", "gate", "state", "pending",
                 "error", "result")

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn
        self.thread: threading.Thread | None = None
        self.gate = threading.Event()
        self.state = "ready"  # ready | done | failed | aborted
        #: the action this task performs when next scheduled:
        #: ("lock", name, lock_id) | ("yield", tag, None) | None (unknown)
        self.pending: tuple | None = None
        self.error: BaseException | None = None
        self.result = None


class Runner:
    """Execute one schedule of a multi-task scenario cooperatively.

    ``schedule`` is a list of indices into the sorted runnable-task list
    at each step; steps beyond the list take index 0 (the "default
    path").  After :meth:`run`, ``decisions`` records every step's
    runnable set and choice — the Explorer's branching input — and
    ``trace`` the chosen task names.
    """

    def __init__(self, schedule: list[int] | None = None,
                 max_steps: int = 20000):
        self.schedule = list(schedule or [])
        self.max_steps = max_steps
        self.clock = 0
        self.trace: list[str] = []
        #: per step: (names of runnable tasks, their pending families,
        #: chosen index)
        self.decisions: list[tuple[tuple[str, ...], tuple[str, ...], int]] = []
        self.deadlocked = False
        self.ran_off_steps = False
        self._tasks: list[_Task] = []
        self._by_ident: dict[int, _Task] = {}
        self._owners: dict[int, _Task] = {}
        self._control = threading.Event()
        self._aborting = False

    # ------------------------------------------------------------ tasks

    def spawn(self, name: str, fn) -> None:
        """Register a task; threads start inside :meth:`run`."""
        self._tasks.append(_Task(name, fn))

    def now(self) -> int:
        """Virtual time: scheduling steps taken so far."""
        return self.clock

    @property
    def failures(self) -> dict[str, BaseException]:
        return {t.name: t.error for t in self._tasks
                if t.state == "failed" and t.error is not None}

    def results(self) -> dict[str, object]:
        return {t.name: t.result for t in self._tasks if t.state == "done"}

    # ------------------------------------------- hook protocol (task side)

    def _current(self) -> _Task | None:
        return self._by_ident.get(threading.get_ident())

    def _park(self, task: _Task) -> None:
        self._control.set()
        task.gate.wait()
        task.gate.clear()
        if self._aborting:
            raise TaskAbort()

    def before_acquire(self, name: str, lock) -> None:
        task = self._current()
        if task is None or self._aborting:
            # during abort, unwinding tasks run concurrently; real lock
            # acquires resolve as their peers unwind and release
            return
        if self._owners.get(id(lock)) is task:
            raise InterleaveError(
                f"task {task.name!r} re-acquiring non-reentrant lock "
                f"{name!r} it already holds — guaranteed self-deadlock")
        task.pending = ("lock", name, id(lock))
        self._park(task)
        # single-threaded here: the scheduler only wakes a task whose
        # pending lock is unowned, so this claim cannot race
        self._owners[id(lock)] = task
        task.pending = None

    def after_release(self, name: str, lock) -> None:
        task = self._current()
        if task is None or self._aborting:
            return
        self._owners.pop(id(lock), None)
        task.pending = ("yield", name, None)
        self._park(task)
        task.pending = None

    def on_wait(self, name: str, cond) -> None:
        if self._current() is None or self._aborting:
            return
        raise InterleaveError(
            f"condition wait on {name!r} under the interleave runner — "
            "parked waiters are not schedulable in this model; drive the "
            "scenario with start=False schedulers and wait-free paths")

    def yield_point(self, tag: str) -> None:
        task = self._current()
        if task is None or self._aborting:
            return
        task.pending = ("yield", tag, None)
        self._park(task)
        task.pending = None

    # --------------------------------------------------- scheduler side

    def _body(self, task: _Task) -> None:
        self._by_ident[threading.get_ident()] = task
        task.gate.wait()
        task.gate.clear()
        try:
            if self._aborting:
                task.state = "aborted"
                return
            task.result = task.fn()
            task.state = "done"
        except TaskAbort:
            task.state = "aborted"
        except BaseException as e:  # recorded, judged by the scenario check
            task.state = "failed"
            task.error = e
        finally:
            self._control.set()

    def _step_into(self, task: _Task) -> None:
        self._control.clear()
        task.gate.set()
        self._control.wait()

    def _runnable(self, live: list[_Task]) -> list[_Task]:
        out = []
        for t in live:
            if t.pending is not None and t.pending[0] == "lock":
                owner = self._owners.get(t.pending[2])
                if owner is not None and owner is not t:
                    continue
            out.append(t)
        return out

    def run(self) -> None:
        for task in self._tasks:
            task.thread = threading.Thread(
                target=self._body, args=(task,),
                name=f"interleave-{task.name}", daemon=True)
            task.thread.start()
        try:
            while True:
                live = [t for t in self._tasks if t.state == "ready"]
                if not live:
                    break
                runnable = sorted(self._runnable(live),
                                  key=lambda t: t.name)
                if not runnable:
                    self.deadlocked = True
                    break
                step = len(self.decisions)
                idx = self.schedule[step] if step < len(self.schedule) else 0
                idx = min(idx, len(runnable) - 1)
                chosen = runnable[idx]
                self.decisions.append((
                    tuple(t.name for t in runnable),
                    tuple("*" if t.pending is None else _family(t.pending[1])
                          for t in runnable),
                    idx))
                self.trace.append(chosen.name)
                self._step_into(chosen)
                self.clock += 1
                if self.clock > self.max_steps:
                    self.ran_off_steps = True
                    break
        finally:
            self._abort_parked()

    def _abort_parked(self) -> None:
        """Unwind every still-parked task so no threads leak; no-op when
        all tasks already finished."""
        parked = [t for t in self._tasks if t.state == "ready"]
        if parked:
            self._aborting = True
            # wake everyone at once: unwinds run concurrently so a task
            # blocked on a peer's real lock resolves as the peer unwinds
            for task in parked:
                task.gate.set()
        for task in self._tasks:
            if task.thread is not None:
                task.thread.join(timeout=5.0)


def run_schedule(build, schedule: list[int] | None = None,
                 max_steps: int = 20000) -> tuple[Runner, list[str]]:
    """Run one scenario under one schedule.  ``build(runner)`` spawns the
    tasks against fresh state and returns a ``check() -> list[str]``
    callable evaluated after the run; scheduler-level violations
    (deadlock, step blow-up) are prepended to its result."""
    runner = Runner(schedule, max_steps=max_steps)
    check = build(runner)
    sanitize.set_interleave_hook(runner)
    try:
        runner.run()
    finally:
        sanitize.set_interleave_hook(None)
    msgs: list[str] = []
    if runner.deadlocked:
        held = {name: t.pending for t in runner._tasks
                for name in [t.name] if t.pending is not None}
        msgs.append(f"deadlock: no runnable task (waiting: {held})")
    if runner.ran_off_steps:
        msgs.append(f"schedule exceeded {runner.max_steps} steps")
    msgs.extend(check() or [])
    return runner, msgs


class Explorer:
    """DFS over the schedule tree with seeded ordering and DPOR-lite
    pruning.  ``build`` is the scenario factory passed to
    :func:`run_schedule`; each run gets fresh state, so schedules are
    independent and replayable."""

    def __init__(self, build, *, seed: int = 0, max_schedules: int = 1000,
                 max_steps: int = 20000, dpor: bool = True):
        self.build = build
        self.rng = random.Random(int(seed))
        self.max_schedules = max_schedules
        self.max_steps = max_steps
        self.dpor = dpor

    def _alternatives(self, prefix_len: int, runner: Runner):
        """Branch points discovered by one run: for every decision at or
        beyond the forced prefix, each not-taken runnable whose pending
        family conflicts with the chosen task's (DPOR-lite; ``*`` =
        unknown action = conservative conflict)."""
        taken = [d[2] for d in runner.decisions]
        for step in range(prefix_len, len(runner.decisions)):
            names, families, chosen = runner.decisions[step]
            if len(names) < 2:
                continue
            chosen_fam = families[chosen]
            for alt in range(len(names)):
                if alt == chosen:
                    continue
                if self.dpor and "*" not in (chosen_fam, families[alt]) \
                        and families[alt] != chosen_fam:
                    continue
                yield taken[:step] + [alt]

    def explore(self) -> dict:
        """Returns ``{"schedules", "violations", "deadlocks", "pruned"}``
        where ``violations`` is ``[(schedule, [messages])]`` — replay any
        entry with :func:`run_schedule`."""
        stack: list[list[int]] = [[]]
        seen: set[tuple[int, ...]] = set()
        out = {"schedules": 0, "violations": [], "deadlocks": 0,
               "max_depth": 0}
        while stack and out["schedules"] < self.max_schedules:
            prefix = stack.pop()
            runner, msgs = run_schedule(self.build, prefix,
                                        max_steps=self.max_steps)
            full = tuple(d[2] for d in runner.decisions)
            if full in seen:
                continue
            seen.add(full)
            out["schedules"] += 1
            out["max_depth"] = max(out["max_depth"], len(full))
            if runner.deadlocked:
                out["deadlocks"] += 1
            if msgs:
                out["violations"].append((list(full), msgs))
            branches = list(self._alternatives(len(prefix), runner))
            self.rng.shuffle(branches)
            stack.extend(branches)
        return out
