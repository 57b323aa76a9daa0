# The port's copy of repro/exec/pool.py: only the package prefix
# of its imports differs.
"""THE two-tier JSON-pipe WORKER/LAUNCHER protocol — defined exactly once.

    parent --json--> launcher (xN) --json--> worker (xW each)

Every real-process route in the repo speaks this protocol:

  WorkerPool      persistent pool: launchers and workers stay alive, tasks
                  stream over stdin/stdout JSON lines (the paper's T3
                  topology reused for dispatch, not just launch). Used by
                  exec.procpool.ProcPoolBackend (ex taskarray.RealRunner).
  launch_once     one-shot launch-time measurement: bring the topology up,
                  time submit -> last ready, tear it down. This is what
                  core.realproc's flat/two-tier harness now routes through.

Wire format (one JSON object per line):

  worker  -> up      {"ready": true}
  launcher-> up      {"ready": true, "workers": W}
  parent  -> task    {"id": str, "expr": str, "params": {...},
                      "inputs": ..., "attempt": int, "sleep": float}
  worker  -> result  {"id": str, "ok": bool, "value"|"error": ...}

Readiness is awaited with a TIMEOUT and failures tear the whole process
tree down (try/finally) — a worker that never comes up may no longer leak
its already-live siblings (the abandoned-children bug of the old realproc
assert path).
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .base import FAULT, READY, RESPAWN, SUBMIT, EventLog, LaunchReport

WORKER_SRC = r"""
import json, math, os, random, sys, time
sys.stdout.write(json.dumps({"ready": True}) + "\n")
sys.stdout.flush()
for line in sys.stdin:
    msg = json.loads(line)
    time.sleep(msg.get("sleep") or 0)           # straggler injection
    env = {"params": msg.get("params") or {}, "inputs": msg.get("inputs"),
           "attempt": msg.get("attempt", 1), "math": math,
           "random": random, "time": time}
    try:
        out = {"id": msg["id"], "ok": True,
               "value": eval(msg["expr"], env)}
        json.dumps(out)                          # serializability check
    except Exception as e:
        out = {"id": msg["id"], "ok": False, "error": repr(e)}
    try:
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()
    except OSError:
        # launcher died under us (chaos SIGKILL): nobody is listening and
        # the parent pool has already reported this attempt lost — exit
        # quietly, skipping the shutdown flush of the broken pipe
        os._exit(0)
"""

# One launcher per "node": forks W workers, then multiplexes task lines
# from the parent onto free workers (a thread per worker serves a shared
# queue) and funnels result lines back up a single locked stdout.
LAUNCHER_SRC = r"""
import json, os, queue, signal, subprocess, sys, threading
W = int(sys.argv[1])
workers = [subprocess.Popen([sys.executable, "-c", %r],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, bufsize=1)
           for _ in range(W)]

def _die(*a):
    # SIGTERM (pool teardown escalating past a hung worker): take the
    # workers down WITH us so none outlive the launcher as orphans
    for w in workers:
        w.kill()
    os._exit(1)

signal.signal(signal.SIGTERM, _die)
for w in workers:
    assert json.loads(w.stdout.readline())["ready"]
sys.stdout.write(json.dumps({"ready": True, "workers": W}) + "\n")
sys.stdout.flush()
q = queue.Queue()
out_lock = threading.Lock()

def serve(w):
    while True:
        line = q.get()
        if line is None:
            return
        w.stdin.write(line)
        w.stdin.flush()
        res = w.stdout.readline()
        with out_lock:
            sys.stdout.write(res)
            sys.stdout.flush()

threads = [threading.Thread(target=serve, args=(w,), daemon=True)
           for w in workers]
for t in threads:
    t.start()
for line in sys.stdin:
    q.put(line)
for _ in workers:                                 # stdin closed: drain+stop
    q.put(None)
for t in threads:
    t.join()
for w in workers:
    w.stdin.close()
for w in workers:
    w.wait()
""" % WORKER_SRC


class ReadinessTimeout(RuntimeError):
    """A spawned process failed to report ready within the timeout."""


def _spawn_worker() -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", WORKER_SRC],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, bufsize=1)


def _spawn_launcher(workers: int) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", LAUNCHER_SRC,
                             str(workers)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, bufsize=1)


def teardown(procs: Sequence[subprocess.Popen]) -> None:
    """Best-effort full reap: close stdin (graceful exit for protocol
    speakers), then terminate/kill stragglers; every handle is wait()ed so
    no zombies survive."""
    for pr in procs:
        try:
            if pr.stdin:
                pr.stdin.close()
        except OSError:
            pass
    deadline = time.monotonic() + 5.0
    for pr in procs:
        try:
            pr.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pr.terminate()
            try:
                pr.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                pr.kill()
                pr.wait()


def await_ready(procs: Sequence[subprocess.Popen], timeout: float,
                on_ready: Optional[Callable[[int, dict], None]] = None
                ) -> None:
    """Block until every proc emits its ready line; raise ReadinessTimeout
    (after recording who failed) otherwise. One reader thread per proc so a
    single hung child cannot block the wait past the deadline."""
    status: List[Optional[dict]] = [None] * len(procs)

    def read(i: int, pr: subprocess.Popen):
        try:
            line = pr.stdout.readline()
            msg = json.loads(line) if line else {}
        except Exception:
            msg = {}
        if msg.get("ready"):
            status[i] = msg
            if on_ready is not None:
                on_ready(i, msg)

    threads = [threading.Thread(target=read, args=(i, pr), daemon=True)
               for i, pr in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    missing = [i for i, s in enumerate(status) if s is None]
    if missing:
        raise ReadinessTimeout(
            f"{len(missing)}/{len(procs)} processes not ready within "
            f"{timeout:.1f}s (indices {missing[:8]}...)")


def launch_once(n_nodes: int, procs_per_node: int, *,
                topology: str = "two-tier", timeout: float = 30.0
                ) -> Tuple[LaunchReport, List[subprocess.Popen]]:
    """One-shot real-process launch-time measurement (paper §III/§IV with
    actual forks). Returns the unified LaunchReport plus the (fully reaped)
    top-level Popen handles so callers/tests can verify cleanup.

      flat      the parent forks every worker itself: N*P sequential
                dispatch operations from one loop.
      two-tier  ONE launcher per node; each launcher spawns its P workers
                locally and reports when all are running (paper T3).
    """
    if topology not in ("flat", "two-tier"):
        raise ValueError(f"real launch_once supports flat|two-tier, "
                         f"got {topology!r}")
    events = EventLog()
    t0 = time.monotonic()
    events.emit(SUBMIT, t0, detail={"topology": topology})
    procs: List[subprocess.Popen] = []
    try:
        if topology == "flat":
            for _ in range(n_nodes * procs_per_node):
                procs.append(_spawn_worker())
        else:
            for _ in range(n_nodes):
                procs.append(_spawn_launcher(procs_per_node))
        await_ready(procs, timeout,
                    on_ready=lambda i, msg: events.emit(
                        READY, time.monotonic(), task=i))
        t_ready = time.monotonic()
    finally:
        teardown(procs)              # also the error path: no orphans
    return (LaunchReport(backend="procpool", topology=topology,
                         n_nodes=n_nodes, procs_per_node=procs_per_node,
                         t_submit=t0, t_ready=t_ready, events=events),
            procs)


class WorkerPool:
    """The persistent SELF-HEALING two-tier pool. `submit` routes a task
    message to the least-loaded LIVE launcher; results arrive on reader
    threads and are handed to `on_result` (set by the backend).
    Thread-safe. If any launcher fails to come up within `ready_timeout`,
    the whole tree is torn down before the error propagates (no abandoned
    children).

    Failure is loud, never silent: submitting to a closed pool raises
    RuntimeError (a silently-dropped task would make the caller's gather
    wait forever), and submit raises once no live launcher remains.

    Recovery (the robustness tentpole): every in-flight task id is tracked
    per launcher, so a launcher whose stdout hits EOF mid-run (crash,
    SIGKILL) immediately

      1. reports each lost in-flight message through `on_lost` — the
         backend feeds these to ArrayDriver.lost(), the fail-fast retry
         path, instead of waiting out RetryPolicy.task_deadline;
      2. is respawned in place with bounded exponential backoff
         (`respawn_backoff * respawn_backoff_factor**k`), a circuit
         breaker after `max_respawn_failures` consecutive failures
         (the slot is then permanently out — graceful degradation to
         reduced capacity), and a `on_fault(kind, detail)` notification
         per crash/respawn/breaker transition (FAULT/RESPAWN events).

    Set respawn=False for the pre-healing semantics: a dead launcher just
    shrinks capacity forever (some regression tests pin this mode)."""

    def __init__(self, n_launchers: int = 2, workers_per_launcher: int = 4,
                 ready_timeout: float = 30.0, respawn: bool = True,
                 respawn_backoff: float = 0.05,
                 respawn_backoff_factor: float = 2.0,
                 max_respawn_failures: int = 3):
        t0 = time.monotonic()
        self.workers_per_launcher = workers_per_launcher
        self.ready_timeout = ready_timeout
        self.respawn = respawn
        self.respawn_backoff = respawn_backoff
        self.respawn_backoff_factor = respawn_backoff_factor
        self.max_respawn_failures = max_respawn_failures
        self.launchers: List[subprocess.Popen] = []  # guarded-by: self._lock
        try:
            for _ in range(n_launchers):
                self.launchers.append(_spawn_launcher(workers_per_launcher))
            await_ready(self.launchers, ready_timeout)
        except BaseException:
            teardown(self.launchers)
            raise
        self.launch_time = time.monotonic() - t0
        self.n_workers = n_launchers * workers_per_launcher
        # handler fields are REASSIGNED between runs (set_handlers), so a
        # reader thread must snapshot them under the lock and invoke the
        # snapshot after releasing it — never call self.on_*() directly
        self.on_result: Callable[[dict], None] \
            = lambda msg: None  # guarded-by: self._lock (analysis: callback)
        self.on_lost: Callable[[dict], None] \
            = lambda msg: None  # guarded-by: self._lock (analysis: callback)
        self.on_fault: Callable[[str, dict], None] \
            = lambda kind, d: None  # guarded-by: self._lock (analysis: callback)
        self.crashes = 0    # guarded-by: self._lock — EOFs outside close()
        self.respawns = 0   # guarded-by: self._lock — slot revivals
        self._outstanding = [0] * n_launchers     # guarded-by: self._lock
        self._inflight: List[Dict[str, dict]] \
            = [{} for _ in range(n_launchers)]    # guarded-by: self._lock
        self._dead = [False] * n_launchers        # guarded-by: self._lock
        self._broken = [False] * n_launchers      # guarded-by: self._lock
        self._all_launchers = list(self.launchers)  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._closed = False                      # guarded-by: self._lock
        self._close_evt = threading.Event()
        self._readers = [threading.Thread(  # guarded-by: self._lock
            target=self._read, args=(i, lp), daemon=True)
            for i, lp in enumerate(self.launchers)]
        for t in self._readers:
            t.start()

    # ---- capacity under degradation -----------------------------------
    @property
    def live_launchers(self) -> int:
        with self._lock:
            return sum(1 for d in self._dead if not d)

    @property
    def live_workers(self) -> int:
        return self.live_launchers * self.workers_per_launcher

    def set_handlers(self,
                     on_result: Optional[Callable[[dict], None]] = None,
                     on_lost: Optional[Callable[[dict], None]] = None,
                     on_fault: Optional[Callable[[str, dict], None]] = None
                     ) -> None:
        """Swap the routing handlers atomically (None resets one to the
        no-op). Backends that reuse a pool across graph runs install the
        run's router here and reset it on the way out; the write happens
        under the pool lock so a reader thread snapshotting mid-swap sees
        either the old or the new handler, never a torn pair."""
        with self._lock:
            self.on_result = on_result or (lambda msg: None)
            self.on_lost = on_lost or (lambda msg: None)
            self.on_fault = on_fault or (lambda kind, d: None)

    def _notify_fault(self, kind: str, detail: dict) -> None:
        """Snapshot on_fault under the lock, invoke it outside — a handler
        that called back into submit()/close() would deadlock otherwise."""
        with self._lock:
            handler = self.on_fault
        handler(kind, detail)

    def _read(self, idx: int, proc: subprocess.Popen):
        """One reader per launcher PROCESS (a respawned slot gets a fresh
        reader bound to the fresh Popen): route results up, and on EOF run
        the crash protocol — reap, report lost in-flight tasks, respawn."""
        for line in proc.stdout:
            try:
                msg = json.loads(line)
            except ValueError:
                continue                  # torn line from a dying launcher
            with self._lock:
                self._outstanding[idx] = max(0, self._outstanding[idx] - 1)
                self._inflight[idx].pop(msg.get("id"), None)
                on_result = self.on_result
            # handler runs with the lock RELEASED: it is backend/user code
            # (ArrayDriver routing) and may call submit() for a retry
            on_result(msg)
        # EOF: the launcher exited — either our clean close or a crash
        try:
            proc.wait()                   # immediate reap: never a zombie
        except OSError:
            pass
        with self._lock:
            self._dead[idx] = True
            lost = list(self._inflight[idx].values())
            self._inflight[idx].clear()
            self._outstanding[idx] = 0
            crashed = not self._closed
            if crashed:
                self.crashes += 1
            on_lost = self.on_lost
        if not crashed:
            return
        self._notify_fault(FAULT, {"launcher": idx, "event": "crash",
                                   "lost": len(lost)})
        for msg in lost:                  # fail-fast, not task_deadline
            on_lost(msg)
        if self.respawn:
            self._respawn(idx)

    def _respawn(self, idx: int) -> None:
        """Bring slot `idx` back: bounded exponential backoff between
        attempts, circuit breaker after max_respawn_failures consecutive
        failures (the slot stays dead; capacity is reduced, not the pool
        killed). Runs on the dead slot's old reader thread."""
        failures = 0
        while True:
            delay = (self.respawn_backoff
                     * self.respawn_backoff_factor ** failures)
            if self._close_evt.wait(delay):
                return                    # pool closing: stand down
            proc = None
            try:
                proc = _spawn_launcher(self.workers_per_launcher)
                await_ready([proc], self.ready_timeout)
            except Exception as e:
                if proc is not None:
                    teardown([proc])
                failures += 1
                self._notify_fault(FAULT, {"launcher": idx,
                                           "event": "respawn-failed",
                                           "failures": failures,
                                           "error": repr(e)})
                if failures >= self.max_respawn_failures:
                    with self._lock:
                        self._broken[idx] = True
                    self._notify_fault(FAULT, {"launcher": idx,
                                               "event": "breaker-open",
                                               "failures": failures})
                    return                # degraded: slot permanently out
                continue
            with self._lock:
                if self._closed:
                    pass                  # lost the race with close()
                else:
                    self.launchers[idx] = proc
                    self._all_launchers.append(proc)
                    self._dead[idx] = False
                    self._outstanding[idx] = 0
                    self.respawns += 1
                    t = threading.Thread(target=self._read,
                                         args=(idx, proc), daemon=True)
                    self._readers.append(t)
                    t.start()
                    proc = None
            if proc is not None:          # closed mid-respawn: reap it
                teardown([proc])
                return
            self._notify_fault(RESPAWN, {"launcher": idx})
            return

    def submit(self, msg: dict) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("pool closed")
            line = json.dumps(msg) + "\n"
            while True:
                live = [i for i in range(len(self.launchers))
                        if not self._dead[i]]
                if not live:
                    raise RuntimeError(
                        "no live launchers (all exited); pool is unusable")
                outstanding = self._outstanding    # bound under the lock
                idx = min(live, key=lambda i: outstanding[i])
                lp = self.launchers[idx]
                try:
                    lp.stdin.write(line)
                    lp.stdin.flush()
                except (OSError, ValueError):
                    self._dead[idx] = True     # died since last read; reroute
                    continue
                self._outstanding[idx] += 1
                if "id" in msg:
                    self._inflight[idx][msg["id"]] = msg
                return

    def close(self, grace: float = 5.0) -> None:
        """Idempotent full teardown, resilient to launchers killed with
        SIGKILL mid-protocol and to hung workers: graceful stdin-close
        first, then escalation through SIGTERM (the launcher kills its
        workers on the way down) to SIGKILL. Every launcher ever spawned —
        including crashed-and-replaced ones — is wait()ed: no zombies, and
        the reader join can no longer wedge on a launcher that will never
        reach EOF on its own."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._close_evt.set()
            launchers = list(self._all_launchers)
            readers = list(self._readers)
        for lp in launchers:
            try:
                if lp.stdin:
                    lp.stdin.close()
            except (OSError, ValueError):
                pass                      # SIGKILLed mid-protocol: the
                                          # buffered flush hits EPIPE
        deadline = time.monotonic() + grace
        for t in readers:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        # escalate: anything still up (hung worker wedging the launcher's
        # drain loop) is terminated, then killed
        teardown([lp for lp in launchers if lp.poll() is None])
        for lp in launchers:
            lp.wait()                     # full reap, incl. replaced slots
        with self._lock:
            readers = list(self._readers)  # a respawn may have raced in
        for t in readers:
            t.join()                      # EOF guaranteed after teardown

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
