"""A world of gloo ranks for a test module: spawned once, awaited as a group,
and made to explain itself when it fails.

``spawn_ranks(tmp_path_factory, name, script, world, extra_args)`` writes
:data:`INIT` and ``script`` into a new temporary directory and starts
``world`` processes of it, rank r with the arguments ``r world store out``
and ``extra_args``: ``store`` the file of the ``file://`` rendezvous,
``out`` the JSON file the rank writes its results to.  :data:`INIT` starts
the rank's gloo group; the script reads its own arguments from
``sys.argv``.

What it guards against:

* **a full pipe** — each rank's stdout and stderr go to one log file under
  ``tmp``, never to a pipe that nobody drains while the fixture waits on
  another rank;
* **a rank stuck in a collective** — the group's collectives time out after
  :data:`COLLECTIVE_S` (the environment's ``RANKS_COLLECTIVE_S``), below the
  fixture's deadline, so the stuck rank raises with its own traceback, and
  ``faulthandler`` dumps every rank's stacks into its log
  :data:`DUMP_MARGIN_S` before the deadline;
* **the host's name** — gloo binds to the loopback interface
  (``GLOO_SOCKET_IFNAME=lo``: every rank is on this host), so no rank
  depends on resolving the host's name (not every host can);
* **one rank dying** — the group is polled as a whole against one deadline
  (:data:`DEADLINE_S`); when a rank exits non-zero, the others get
  :data:`GRACE_S` to finish or fail on their own, then are killed;
* **two worlds at once** — a module's world takes a file lock under the
  session's shared temporary root before it starts, so that the worlds of
  the modules that ``pytest -n N`` runs side by side do not oversubscribe
  the cores together (gloo's collectives wait for the slowest rank, and a
  rank that waits for a core makes every rank wait); the deadline counts
  from the lock, and a world waits for it at most :data:`LOCK_WAIT_S`.

On failure the assertion names every rank's return code and the tail of
its log.  Not collected: the name does not start with ``test_``.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the whole world's deadline, from the lock: ``tests/test_torch_tp.py``'s
#: world took 92 s alone on an 8-core host, 159 s inside the full ``-n 6``
#: run there, 174 s with five other heavy modules pinned to 4 cores and 211
#: s with three pinned to 2 (the longest of the three worlds)
DEADLINE_S = 480.0
#: each rank's collective timeout (``init_process_group(timeout=)``)
COLLECTIVE_S = 240.0
#: the longest wait for another module's world to end; past it the world
#: starts anyway (the report says so), so that a world stuck to its deadline
#: delays the others by at most this much
LOCK_WAIT_S = 240.0
#: every rank's Python stacks go into its log this long before the deadline
DUMP_MARGIN_S = 30.0
#: how long the other ranks may run on after one has failed
GRACE_S = 20.0
#: bytes of each rank's log that a failure reports
TAIL = 3000

#: the lines a rank script starts with: the stack dump before the deadline
#: (at a time of the clock, however late the rank started), then the group
#: with its collective timeout
INIT = r'''
import datetime as _dt, faulthandler as _fh, os as _os, sys as _sys, time as _time
_fh.dump_traceback_later(max(0.1, float(_os.environ["RANKS_DUMP_AT"]) - _time.time()), exit=False)
import torch.distributed as _dist
_dist.init_process_group(
    "gloo", init_method=f"file://{_sys.argv[3]}", rank=int(_sys.argv[1]),
    world_size=int(_sys.argv[2]),
    timeout=_dt.timedelta(seconds=float(_os.environ["RANKS_COLLECTIVE_S"])))
'''


def _lock_path(tmp_path_factory) -> Path:
    """A file that every xdist worker of the session sees: the parent of the
    workers' ``basetemp`` directories (the ``basetemp`` itself without
    xdist)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return base / "spawned_ranks.lock"


def spawn_ranks(tmp_path_factory, name: str, script: str, world: int, extra_args=(),
                deadline_s: float = DEADLINE_S) -> list[dict]:
    """Runs ``script`` (after :data:`INIT`) on ``world`` ranks in a new
    directory ``name`` of ``tmp_path_factory`` (see the module docstring)
    and returns each rank's JSON results, in rank order."""
    tmp = tmp_path_factory.mktemp(name)
    path = tmp / "rank.py"
    path.write_text(INIT + script)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "HOME": str(tmp),
           "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp), "GLOO_SOCKET_IFNAME": "lo",
           "RANKS_COLLECTIVE_S": str(min(COLLECTIVE_S, deadline_s / 2))}
    with open(_lock_path(tmp_path_factory), "a") as held:
        t0, locked = time.monotonic(), False
        while not locked and time.monotonic() - t0 < LOCK_WAIT_S:
            try:
                fcntl.flock(held, fcntl.LOCK_EX | fcntl.LOCK_NB)
                locked = True
            except BlockingIOError:
                time.sleep(0.5)
        waited = f"{time.monotonic() - t0:.1f} s waiting for the lock" + (
            "" if locked else ", then ran without it")
        try:
            return _run(path, world, tmp, extra_args, env, deadline_s, waited)
        finally:
            if locked:
                fcntl.flock(held, fcntl.LOCK_UN)


def _run(path: Path, world: int, tmp: Path, extra_args, env: dict, deadline_s: float,
         waited: str) -> list[dict]:
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    t0 = time.monotonic()
    env = {**env, "RANKS_DUMP_AT": str(time.time() + max(deadline_s - DUMP_MARGIN_S,
                                                          deadline_s / 2))}
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(path), str(r), str(world), str(tmp / "store"),
                     str(tmp / f"rank{r}.json"), *map(str, extra_args)],
                    stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=str(tmp)))
        deadline = t0 + deadline_s
        failed_at = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            now = time.monotonic()
            if failed_at is None and any(c not in (None, 0) for c in codes):
                failed_at = now
            if now >= deadline or (failed_at is not None and now >= failed_at + GRACE_S):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.monotonic() - t0
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        what = "the deadline" if wall >= deadline_s else "a rank's failure"
        report = [f"{len(procs)} of {world} ranks started; stopped by {what} after "
                  f"{wall:.1f} s (deadline {deadline_s:.0f} s, {waited}); return codes "
                  f"{codes}"]
        for r, log in enumerate(logs):
            text = log.read_text(errors="replace") if log.exists() else "(no log)"
            report.append(f"--- rank {r} (exit {codes[r] if r < len(codes) else None}), "
                          f"last {TAIL} bytes of its log:\n{text[-TAIL:]}")
        raise AssertionError("\n".join(report))
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
