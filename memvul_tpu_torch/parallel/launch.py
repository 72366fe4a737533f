"""The local launcher behind ``--mesh SPEC``: the calling process becomes
rank 0 of a world of ``world_size`` and starts ranks 1..n−1 as child
processes of the same command.

Each child gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT`` (the env ``torchrun`` gives, which
:func:`~.mesh.create_mesh` joins from) and writes its output to
``<log_dir>/rank-<r>.log``.  A rank that fails ends the world: a child
that exits non-zero makes the launcher kill the others and exit 1 (its
:class:`World` watcher), rank 0 raising kills the children on the way
out (:meth:`World.close`), and a child whose parent dies exits.  Every
join and collective carries the world's timeout besides
(:data:`~.multihost.DEFAULT_TIMEOUT_S`).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

logger = logging.getLogger(__name__)

# the env marker of a launched child: its parent's pid, which it watches
PARENT_ENV = "MEMVUL_LAUNCH_PARENT"


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def is_launched_child() -> bool:
    return bool(os.environ.get(PARENT_ENV))


def in_world() -> bool:
    """True where a world is joined or a launcher's env says how to join
    one (this process is a launched child, or runs under ``torchrun``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    return bool(os.environ.get("MASTER_ADDR")) and bool(os.environ.get("WORLD_SIZE"))


def watch_parent(poll_s: float = 1.0) -> None:
    """In a launched child: exit once the launcher is gone (a daemon
    thread), so a killed rank 0 never leaves ranks waiting on a
    collective."""
    parent = int(os.environ.get(PARENT_ENV, "0") or 0)
    if not parent:
        return

    def watch():
        while True:
            if os.getppid() != parent:
                sys.stderr.write("launcher is gone: this rank exits\n")
                sys.stderr.flush()
                os._exit(1)
            time.sleep(poll_s)

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


class World:
    """Ranks 1..n−1 of a local world, started by :func:`spawn`."""

    def __init__(self, procs: List[subprocess.Popen], logs: List[Path]) -> None:
        self.procs = procs
        self.logs = logs
        self._closing = False
        self._watcher = threading.Thread(target=self._watch, daemon=True, name="world-watch")
        self._watcher.start()

    def _watch(self) -> None:
        """A child that fails ends the world: the others are killed and
        this process exits 1 (it may be blocked in a collective)."""
        while not self._closing:
            for rank, p in enumerate(self.procs, start=1):
                rc = p.poll()
                if rc is not None and rc != 0 and not self._closing:
                    sys.stderr.write(
                        f"rank {rank} exited with {rc} (log: {self.logs[rank - 1]}): "
                        "ending the world\n")
                    sys.stderr.flush()
                    self.kill()
                    os._exit(1)
            time.sleep(0.2)

    def _name_dead(self, grace_s: float) -> None:
        """Name each child that failed on its own, waiting up to
        ``grace_s`` for one to be seen: rank 0 can fail first because a
        peer died (its collective breaks before the watcher's next poll)."""
        deadline = time.monotonic() + grace_s
        while True:
            dead = [(rank, p.poll()) for rank, p in enumerate(self.procs, start=1)
                    if p.poll() not in (None, 0)]
            if dead or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        for rank, rc in dead:
            sys.stderr.write(f"rank {rank} exited with {rc} (log: {self.logs[rank - 1]}): "
                             "ending the world\n")
        sys.stderr.flush()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def close(self, ok: bool, timeout_s: float = 600.0) -> int:
        """Rank 0 is done: with ``ok``, wait for every child and return 0
        only if each exited 0; otherwise kill them and return 1."""
        self._closing = True
        if not ok:
            self._name_dead(grace_s=0.5)
            self.kill()
            return 1
        deadline = time.monotonic() + timeout_s
        rc = 0
        for rank, p in enumerate(self.procs, start=1):
            try:
                code = p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                sys.stderr.write(f"rank {rank} did not finish within {timeout_s:.0f}s\n")
                code = -1
            if code != 0:
                sys.stderr.write(f"rank {rank} exited with {code} (log: {self.logs[rank - 1]})\n")
                rc = 1
        if rc:
            self.kill()
        return rc


def _world_env(world_size: int, port: str) -> Dict[str, str]:
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": port, "WORLD_SIZE": str(world_size)}


def _start_rank(cmd: Sequence[str], rank: int, world: Dict[str, str], log: Path,
                env: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """Rank ``rank`` of ``world`` as a child running ``cmd``, its output
    to ``log``; it watches this process (:func:`watch_parent`)."""
    child_env = dict(os.environ)
    child_env.update(env or {})
    child_env.update(world, RANK=str(rank), LOCAL_RANK=str(rank))
    child_env[PARENT_ENV] = str(os.getpid())
    with open(log, "w") as out:
        return subprocess.Popen(list(cmd), env=child_env, stdout=out, stderr=subprocess.STDOUT)


def spawn(argv: Sequence[str], world_size: int, log_dir: Union[str, Path]) -> World:
    """Start ranks 1..``world_size``−1 as ``python -m memvul_tpu_torch
    <argv>`` and set this process's env as rank 0 of the same world."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    world = _world_env(world_size, str(free_port()))
    logs = [log_dir / f"rank-{rank}.log" for rank in range(1, world_size)]
    procs = [_start_rank([sys.executable, "-m", "memvul_tpu_torch", *argv], rank, world, log)
             for rank, log in enumerate(logs, start=1)]
    os.environ.update(world, RANK="0", LOCAL_RANK="0")
    logger.info("launched ranks 1..%d of a world of %d (logs in %s)", world_size - 1,
                world_size, log_dir)
    return World(procs, logs)


def run_ranks(
    target: str,
    world_size: int,
    work_dir: Union[str, Path],
    kwargs: Optional[Dict] = None,
    timeout_s: float = 120.0,
    env: Optional[Dict[str, str]] = None,
    python_path: Sequence[str] = (),
) -> List:
    """Run ``target`` (``"module:function"``) as rank 0..n−1 of a fresh
    local world, one process each, and return each rank's result (the
    function's JSON-able return, called with ``kwargs``).  Each rank's
    output goes to ``<work_dir>/rank-<r>.log``.  A rank that fails, or a
    world that outlives ``timeout_s``, is killed whole and raises."""
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    args_file = work_dir / "args.json"
    args_file.write_text(json.dumps(kwargs or {}))
    world = _world_env(world_size, str(free_port()))
    env = dict(env or {})
    if python_path:
        env["PYTHONPATH"] = os.pathsep.join(
            [*map(str, python_path), env.get("PYTHONPATH", os.environ.get("PYTHONPATH", ""))])
    logs = [work_dir / f"rank-{rank}.log" for rank in range(world_size)]
    procs = [_start_rank([sys.executable, "-m", __name__, target, str(args_file),
                          str(work_dir / f"rank-{rank}.json")], rank, world, log, env)
             for rank, log in enumerate(logs)]
    deadline = time.monotonic() + timeout_s
    failure = None
    while failure is None:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            failure = f"rank {bad[0][0]} exited with {bad[0][1]}"
        elif all(c == 0 for c in codes):
            break
        elif time.monotonic() > deadline:
            failure = f"the world did not finish within {timeout_s:.0f}s"
        else:
            time.sleep(0.05)
    if failure is not None:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        tails = "\n".join(f"--- rank {r} ---\n{log.read_text()[-3000:]}" for r, log in enumerate(logs))
        raise RuntimeError(f"{target}: {failure}\n{tails}")
    return [json.loads((work_dir / f"rank-{r}.json").read_text()) for r in range(world_size)]


def _rank_main(argv: Sequence[str]) -> int:
    """A :func:`run_ranks` child: call the target, write its result."""
    import importlib

    target, args_file, out_file = argv
    watch_parent()
    module, fn = target.split(":")
    result = getattr(importlib.import_module(module), fn)(**json.loads(Path(args_file).read_text()))
    Path(out_file).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    code = _rank_main(sys.argv[1:])
    sys.stdout.flush()
    sys.stderr.flush()
    # the result is written: skip the interpreter's teardown, where a
    # process group the target left joined can abort its exit (a gloo
    # thread destroyed while still joinable)
    os._exit(code)
