"""One scoring service across the ranks of a mesh: the leader's command
channel (:class:`MeshLeader`) and the followers' loop (:func:`follow`).

The JAX package has no counterpart of this module: one controller drives
every device of its mesh, so its ``ScoringService`` scores a sharded block
with one call.  The port runs one process per card (``parallel/launch.py``)
and a collective completes only when every rank joins it, so one service
is split:

* rank 0, the **leader**, runs the whole service (the HTTP front end, the
  batcher, admission, the admission cache, tenants, the monitors, the
  flight recorder, ``/programz``, the run sinks); its ``SiamesePredictor``
  carries a :class:`MeshLeader` as its ``channel``;
* ranks 1..n−1, the **followers**, run :func:`follow`: each waits for the
  leader's next command, then runs the predictor code the leader runs, so
  every collective of that code (the gather of the data slices and the
  bank shards) is met on every rank in the leader's order.  A follower
  writes nothing.

Each command broadcasts a header of :data:`HEADER_LEN` int64s, ``[op,
bank id, a, b]``, then its payload:

``OP_SCORE`` / ``OP_SCORE_INT8``
    a bucket block's token ids and mask (``[2, rows, length]`` int32, so
    followers never tokenize), scored against bank ``id`` at full
    precision or on the int8 tier;
``OP_INSTALL``
    an anchor bank's token ids and mask in ``anchor_chunk`` blocks (``a``
    anchors in ``b`` rows): every rank encodes it and keeps its ``model``
    shard under ``id``, and the ranks agree that each succeeded before any
    keeps it (a failure on one leaves every rank's banks as they were);
``OP_DROP``
    forget bank ``id``;
``OP_WARM``
    run every serving shape once against bank ``id``;
``OP_KEEPALIVE``
    nothing: sent once the channel has been idle for
    :attr:`MeshLeader.keepalive_s` (a quarter of the world's timeout), so an
    idle service keeps its world while a dead leader still ends it (the
    followers' wait for a header times out);
``OP_STOP``
    the followers return.

The leader holds one lock around each command and all of its collectives:
the batcher, a swap's caller, the shadow scorer and the promotion gates
all reach the predictor, and every rank must issue its collectives in one
order.  A bank tensor carries its id (:data:`BANK_ID_ATTR`).  When the
leader's last reference to an installed bank goes (no snapshot and no
micro-batch in flight holds it), its id is queued and dropped on every
rank before the next command.  A command that fails after its header was
sent leaves the ranks out of step: the channel is marked failed
(:attr:`MeshLeader.failed`), refuses every later command, and ``serve``
exits non-zero.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.mesh import broadcast_header, broadcast_tensor
from ..resilience.retry import exception_text

logger = logging.getLogger(__name__)

HEADER_LEN = 4
OP_STOP, OP_KEEPALIVE, OP_SCORE, OP_SCORE_INT8, OP_INSTALL, OP_DROP, OP_WARM = range(7)
OP_NAMES = ("stop", "keepalive", "score", "score_int8", "install", "drop", "warm")
# the attribute an installed bank tensor carries: its id on every rank
BANK_ID_ATTR = "_mesh_bank_id"


class MeshChannelError(RuntimeError):
    """The channel is stopped, or failed and left the ranks out of step."""


class BankInstallError(RuntimeError):
    """A bank install failed on some rank; every rank kept its old banks."""


def bank_id(bank) -> int:
    """The mesh id of an installed bank tensor."""
    ident = getattr(bank, BANK_ID_ATTR, None)
    if ident is None:
        raise MeshChannelError(
            "this anchor bank is not installed on the mesh's ranks: build it with the "
            "predictor's encode_bank")
    return int(ident)


def block_payload(block: Dict[str, np.ndarray]) -> torch.Tensor:
    """A block's token ids and mask as one ``[2, rows, length]`` int32
    tensor, what a command carries."""
    return torch.from_numpy(np.stack([block["input_ids"], block["attention_mask"]]).astype(np.int32))


def _recv_block(mesh, rows: int, length: int) -> Dict[str, np.ndarray]:
    payload = broadcast_tensor(None, (2, rows, length), torch.int32, mesh).cpu().numpy()
    return {"input_ids": payload[0], "attention_mask": payload[1]}


class MeshLeader:
    """Rank 0's end of the command channel over ``mesh``, for
    ``predictor`` (whose encoded startup bank becomes id 0 on every rank).
    A daemon thread sends a keep-alive once the channel has been idle for
    :attr:`keepalive_s`, a quarter of the world's timeout."""

    def __init__(self, mesh, predictor) -> None:
        if not mesh.is_primary:
            raise ValueError("the command channel's leader is rank 0")
        self.mesh = mesh
        self.keepalive_s = mesh.timeout_s / 4
        self._lock = threading.RLock()
        self._depth = 0  # guarded by _lock: >0 inside this thread's command
        self._next_id = 1
        # ids of banks the leader no longer holds; a finalizer appends from
        # any thread (a deque's append needs no lock)
        self._drops: "collections.deque[int]" = collections.deque()
        self._stopped = False
        self.failed: Optional[str] = None
        self.commands: "collections.Counter[str]" = collections.Counter()
        self._last = time.monotonic()
        setattr(predictor.anchor_bank, BANK_ID_ATTR, 0)
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._keepalive, name="memvul-mesh-keepalive",
                                        daemon=True)
        self._thread.start()

    @contextlib.contextmanager
    def command(self, op: int, ident: int = 0, a: int = 0, b: int = 0,
                payload: Optional[torch.Tensor] = None):
        """Hold the channel, send the header and the payload, and run the
        body (this rank's share of the command's collectives).  Inside a
        command of the same thread it sends nothing: the nested call's
        collectives are part of the outer command."""
        with self._lock:
            if self._depth:
                self._depth += 1
                try:
                    yield
                finally:
                    self._depth -= 1
                return
            if self._stopped:
                raise MeshChannelError("the mesh channel is stopped")
            if self.failed is not None:
                raise MeshChannelError(f"the mesh channel failed earlier: {self.failed}")
            self._depth = 1
            try:
                self._send_drops()
                self._send(op, ident, a, b, payload)
                yield
            except BankInstallError:
                raise  # the ranks agreed on it: still in step
            except BaseException as e:
                self.failed = f"{OP_NAMES[op]}: {exception_text(e)[:300]}"
                logger.error("mesh command failed; the ranks are out of step: %s", self.failed)
                raise
            finally:
                self._depth = 0
                self._last = time.monotonic()

    def _send(self, op: int, ident: int, a: int, b: int, payload) -> None:
        broadcast_header([op, ident, a, b], HEADER_LEN, self.mesh)
        if payload is not None:
            broadcast_tensor(payload, payload.shape, payload.dtype, self.mesh)
        self.commands[OP_NAMES[op]] += 1

    def _send_drops(self) -> None:
        while True:
            try:
                ident = self._drops.popleft()
            except IndexError:
                return
            self._send(OP_DROP, ident, 0, 0, None)

    def score(self, bank, block: Dict[str, np.ndarray], int8: bool = False):
        """The command around one block's scoring, at full precision or on
        the int8 tier."""
        rows, length = block["input_ids"].shape
        return self.command(OP_SCORE_INT8 if int8 else OP_SCORE, bank_id(bank), rows, length,
                            block_payload(block))

    def warm(self, bank):
        """The command around a warmup of every serving shape."""
        return self.command(OP_WARM, bank_id(bank))

    def install(self, block: Dict[str, np.ndarray], n_anchors: int, build) -> torch.Tensor:
        """Install a bank on every rank: send its blocks, run ``build(block,
        n_anchors)`` (this rank's shard, after the ranks agreed), and tag
        the result with its new id, which is dropped on every rank once the
        leader no longer holds the tensor."""
        with self._lock:
            ident = self._next_id
            self._next_id += 1
            with self.command(OP_INSTALL, ident, n_anchors, block["input_ids"].shape[0],
                              block_payload(block)):
                bank = build(block, n_anchors)
        setattr(bank, BANK_ID_ATTR, ident)
        weakref.finalize(bank, self._drops.append, ident)
        return bank

    def stop(self) -> None:
        """Send the stop command (once; a failed channel sends nothing) and
        end the keep-alive thread."""
        self._done.set()
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            if self.failed is None:
                try:
                    self._send(OP_STOP, 0, 0, 0, None)
                except Exception as e:  # the followers are gone: the world ends anyway
                    self.failed = f"stop: {exception_text(e)[:300]}"
                    logger.error("could not stop the followers: %s", self.failed)

    def _keepalive(self) -> None:
        poll = max(0.05, min(1.0, self.keepalive_s / 4))
        while not self._done.wait(poll):
            if time.monotonic() - self._last < self.keepalive_s:
                continue
            try:
                with self.command(OP_KEEPALIVE):
                    pass
            except Exception:
                return  # stopped, or failed (marked so: serve exits non-zero)


def follow(mesh, predictor) -> Dict[str, int]:
    """A follower's loop: run each command of rank 0's channel until the
    stop command, against the banks installed so far (the startup bank is
    id 0).  Returns the count of each command run.  A collective that
    fails or times out (a dead leader) raises."""
    banks: Dict[int, torch.Tensor] = {0: predictor.anchor_bank}
    counts: "collections.Counter[str]" = collections.Counter()
    max_length = predictor.encoder.max_length
    while True:
        op, ident, a, b = broadcast_header(None, HEADER_LEN, mesh)
        if not 0 <= op < len(OP_NAMES):
            raise MeshChannelError(f"unknown mesh command {op}")
        counts[OP_NAMES[op]] += 1
        if op == OP_STOP:
            return dict(counts)
        if op == OP_DROP:
            banks.pop(ident, None)
        elif op in (OP_SCORE, OP_SCORE_INT8):
            block = _recv_block(mesh, a, b)
            score = predictor.score_block_int8 if op == OP_SCORE_INT8 else predictor.score_block
            score(block, banks[ident])
        elif op == OP_INSTALL:
            block = _recv_block(mesh, b, max_length)
            try:
                banks[ident] = predictor._install_block(block, a)
            except BankInstallError as e:
                logger.warning("bank %d was not installed: %s", ident, e)
        elif op == OP_WARM:
            predictor.warmup_bank_shapes(banks[ident])


class MeshFollower:
    """What ``serve_from_archive`` returns on a follower rank: :meth:`run`
    blocks in :func:`follow` until the leader's stop command."""

    def __init__(self, mesh, predictor) -> None:
        self.mesh = mesh
        self.predictor = predictor

    def run(self) -> Dict[str, int]:
        counts = follow(self.mesh, self.predictor)
        logger.info("follower rank %d stopped after %s", self.mesh.rank, counts)
        return counts
