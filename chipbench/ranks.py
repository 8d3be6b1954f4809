"""One process a card for a cell of ``chips`` N > 1.

The process that ``run.py`` was started as is rank 0 (``lead``): it
starts ranks 1 .. N-1 as processes of their own (the same command with
``--rank``, ``--world``, ``--store`` and ``--parent`` added), each of
which ``follow``s.  Every rank joins one process group, NCCL on its card
(``device_id`` bound) or gloo on the CPU, through a ``file://`` store in
a temporary directory, and a second, gloo group over the same ranks for
the host's barriers, decisions and object gathers, so that none of them
launches a kernel.  Every rank then runs the same body (``run_cell`` or
``calibrate``) from the same seed; rank 0 alone prints the result.

A run ends non-zero, printing no result, when any rank raises or exits
non-zero (rank 0 watches the others and takes them down with it), when a
collective waits longer than ``TIMEOUT_S``, or when a rank holds a
forbidden module once its body has ended (exit 3).  A rank that loses
its parent dies with it (``PR_SET_PDEATHSIG``).

With ``chips`` 1 nothing here runs: the harness uses ``Solo``, which
spawns nothing and opens no process group.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import traceback
from datetime import timedelta
from typing import Any, Callable, List

__all__ = ["TIMEOUT_S", "Solo", "Team", "lead", "follow"]

# the longest a collective or the group's start may wait (chip_smoke.py's
# TP_TIMEOUT_S)
TIMEOUT_S = 300.0
# how often rank 0 looks at the other ranks
POLL_S = 0.2


class Solo:
    """The one-card run: one rank, no group, nothing to wait for."""

    rank, world = 0, 1

    def barrier(self) -> None:
        pass

    def agree(self, value):
        return value

    def gather(self, obj) -> List[Any]:
        return [obj]


class Team:
    """This process's rank of ``world``: the default group (NCCL on card
    ``rank``, or gloo with ``device_type`` 'cpu') and a gloo group over
    the same ranks for the host's side."""

    def __init__(self, rank: int, world: int, store: str,
                 device_type: str = "cuda"):
        import torch
        import torch.distributed as dist

        self.rank, self.world = int(rank), int(world)
        timeout = timedelta(seconds=TIMEOUT_S)
        kw = {}
        if device_type == "cuda":
            torch.cuda.set_device(self.rank)
            kw["device_id"] = torch.device("cuda", self.rank)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"file://{store}",
                                rank=self.rank, world_size=self.world,
                                timeout=timeout, **kw)
        self.host = (dist.new_group(backend="gloo", timeout=timeout)
                     if device_type == "cuda" else None)
        self._dist = dist

    def barrier(self) -> None:
        self._dist.barrier(group=self.host)

    def agree(self, value):
        """Rank 0's ``value``, on every rank."""
        box = [value]
        self._dist.broadcast_object_list(box, src=0, group=self.host)
        return box[0]

    def gather(self, obj) -> List[Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.world
        self._dist.all_gather_object(out, obj, group=self.host)
        return out

    def close(self) -> None:
        if self._dist.is_initialized():
            self._dist.destroy_process_group()


def _forbidden() -> List[str]:
    from chipbench.harness import forbidden_modules
    return forbidden_modules()


def _say(msg: str) -> None:
    print(f"[chipbench] {msg}", file=sys.stderr, flush=True)


class _Ranks:
    """Rank 0's handle on ranks 1 .. N-1: the group's store in a
    temporary directory, the ranks started as ``cmd`` plus their rank
    arguments and watched by a thread that ends this process when one of
    them fails; ``stop`` kills what is left, waits for it and removes
    the directory."""

    def __init__(self, world: int, cmd: List[str]):
        self.tmp = tempfile.mkdtemp(prefix="chipbench-ranks-")
        self.store = os.path.join(self.tmp, "store")
        self.procs = [subprocess.Popen(
            cmd + ["--rank", str(r), "--world", str(world), "--store",
                   self.store, "--parent", str(os.getpid())])
            for r in range(1, world)]
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()

    def _watcher(self) -> None:
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0):
                    _say(f"rank {r} exited with {rc}: the run fails")
                    self.stop()
                    os._exit(rc if rc > 0 else 1)

    def finish(self) -> List[int]:
        """Wait for every rank to exit; their exit codes."""
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=TIMEOUT_S))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        self._done.set()
        return rcs

    def stop(self) -> None:
        self._done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self._watch is not threading.current_thread():
            self._watch.join(timeout=5)


def lead(world: int, cmd: List[str], device_type: str,
         body: Callable[[Any], Any]) -> Any:
    """Rank 0: start ranks 1 .. world-1 as ``cmd`` plus their rank
    arguments, join the group, run ``body(team)``, and return its value
    once every rank has ended cleanly.  Raises ``SystemExit`` (printing
    why) if a rank fails or holds a forbidden module."""
    ranks = _Ranks(world, cmd)
    team = None
    try:
        team = Team(0, world, ranks.store, device_type)
        out = body(team)
        found = team.gather(_forbidden())
        team.close()
        rcs = ranks.finish()
        bad = {r: rc for r, rc in enumerate(rcs, 1) if rc != 0}
        if bad:
            _say(f"ranks ended with {bad}: the run fails")
            raise SystemExit(1)
        held = {r: f for r, f in enumerate(found) if f}
        if held:
            _say(f"forbidden modules loaded, by rank: {held}")
            raise SystemExit(3)
        return out
    finally:
        ranks.stop()
        if team is not None:
            team.close()


class _Prefixed:
    """A text stream that writes each whole line to ``dest`` after
    ``prefix``, in one write, so that the lines of several processes on
    one stream do not interleave."""

    def __init__(self, dest, prefix: str):
        self.dest, self.prefix, self._part = dest, prefix, ""

    def write(self, s: str) -> int:
        lines = (self._part + s).split("\n")
        self._part = lines.pop()
        for line in lines:
            self.dest.write(f"{self.prefix}{line}\n")
            self.dest.flush()
        return len(s)

    def flush(self) -> None:
        if self._part:
            self.write("\n")
        self.dest.flush()


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when its parent ends; end now if
    the parent has already gone."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
        prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
        prctl.restype = ctypes.c_int
        prctl(1, int(signal.SIGKILL), 0, 0, 0)       # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def follow(rank: int, world: int, store: str, parent: int,
           device_type: str, body: Callable[[Any], Any]) -> int:
    """Rank ``rank`` > 0: log to standard error under ``[rank r]``, join
    the group, run ``body(team)``, report its forbidden modules to rank 0;
    the process's exit code (1 if the body raised)."""
    _die_with(parent)
    sys.stdout = _Prefixed(sys.__stderr__, f"[rank {rank}] ")
    sys.stderr = sys.stdout
    try:
        team = Team(rank, world, store, device_type)
        body(team)
        found = team.gather(_forbidden())
        team.close()
        return 3 if found[rank] else 0
    except Exception:           # the rank's boundary: report and fail
        traceback.print_exc()
        return 1
    finally:
        sys.stdout.flush()
