"""The ranks of a cell on several cards: rank 0 is the command itself and
starts ranks 1..n-1 as children running the same command, each told its
rank through ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` (what the program's ``--mesh`` launcher gives its ranks).

A child's output goes to a log in a temporary directory of its own; a
child exits when rank 0 is gone, and rank 0 ends the world when a child
fails.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Sequence

PARENT_ENV = "PERFBENCH_PARENT"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def rank() -> int:
    return int(os.environ.get("RANK", "0")) if os.environ.get(PARENT_ENV) else 0


def watch_parent(poll_s: float = 0.5) -> None:
    """In a child: exit once rank 0 is gone."""
    parent = int(os.environ.get(PARENT_ENV, "0") or 0)
    if not parent:
        return

    def watch() -> None:
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(poll_s)

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


class World:
    """Ranks 1..n-1, started by :meth:`start`."""

    def __init__(self, procs: List[subprocess.Popen], logs: List[Path], log_dir: Path) -> None:
        self.procs, self.logs, self.log_dir = procs, logs, log_dir
        self._closing = False
        threading.Thread(target=self._watch, daemon=True, name="world-watch").start()

    @classmethod
    def start(cls, argv: Sequence[str], size: int) -> "World":
        """Start ranks 1..``size``-1 as ``python <argv>`` and make this
        process rank 0 of the same world."""
        log_dir = Path(tempfile.mkdtemp(prefix="perfbench-ranks-"))
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
               "WORLD_SIZE": str(size)}
        procs, logs = [], []
        for r in range(1, size):
            log = log_dir / f"rank-{r}.log"
            child = dict(os.environ, **env, RANK=str(r), LOCAL_RANK=str(r))
            child[PARENT_ENV] = str(os.getpid())
            with open(log, "w") as out:
                procs.append(subprocess.Popen([sys.executable, *argv], env=child, stdout=out,
                                              stderr=subprocess.STDOUT))
            logs.append(log)
        os.environ.update(env, RANK="0", LOCAL_RANK="0")
        return cls(procs, logs, log_dir)

    def _watch(self) -> None:
        while not self._closing:
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code not in (None, 0) and not self._closing:
                    sys.stderr.write(f"rank {r} exited with {code}:\n{self.tail(r)}\n")
                    sys.stderr.flush()
                    self.kill()
                    os._exit(1)
            time.sleep(0.2)

    def tail(self, r: int, chars: int = 3000) -> str:
        try:
            return self.logs[r - 1].read_text()[-chars:]
        except OSError:
            return ""

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def close(self, ok: bool, timeout_s: float = 120.0) -> bool:
        """Wait for every child (kill them unless ``ok``); True when each
        exited 0.  Removes the logs."""
        self._closing = True
        good = ok
        if ok:
            deadline = time.monotonic() + timeout_s
            for r, p in enumerate(self.procs, start=1):
                try:
                    code = p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    code = None
                if code != 0:
                    sys.stderr.write(f"rank {r} ended with {code}:\n{self.tail(r)}\n")
                    good = False
        if not good:
            self.kill()
        shutil.rmtree(self.log_dir, ignore_errors=True)
        return good
