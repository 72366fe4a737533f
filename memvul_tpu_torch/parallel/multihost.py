"""Multi-process initialization over ``torch.distributed`` (the JAX
package's ``parallel/multihost.py``).

The port runs one process per card, PyTorch's idiom: a world of N ranks,
rank ``r`` on ``cuda:{LOCAL_RANK}``, NCCL between cards, gloo between
CPU processes.  :func:`initialize` joins such a world only on explicit
arguments or launch markers: ``MEMVUL_MULTIHOST``, or the ``MASTER_ADDR``
and ``WORLD_SIZE`` pair that ``torchrun`` sets.  A world it joined sets
:data:`_initialized`, which the fleet's host enumeration reads; the worlds
that ``--mesh`` starts (:mod:`.launch`) go through :func:`join_world`
and leave it unset.

Typical launch (the same program on every rank)::

    from memvul_tpu_torch.parallel import multihost, create_mesh
    multihost.initialize()                 # torchrun's env
    mesh = create_mesh({"data": -1})       # every rank of the world
    ...
    if multihost.is_primary():             # one writer of checkpoints and logs
        save(...)
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_initialized = False

# a join, and every collective of the world, gives up after this long: a
# rank that dies or skips a collective ends the world instead of hanging it
DEFAULT_TIMEOUT_S = 300.0
# the env that sets another timeout for the worlds a process joins (the
# launched ranks of a ``--mesh`` command inherit it)
TIMEOUT_ENV = "MEMVUL_WORLD_TIMEOUT_S"

_ENV_MARKERS = ("MEMVUL_MULTIHOST",)


def world_timeout_s() -> float:
    """The timeout of a world joined without an explicit one:
    ``$MEMVUL_WORLD_TIMEOUT_S``, else :data:`DEFAULT_TIMEOUT_S`."""
    return float(os.environ.get(TIMEOUT_ENV) or DEFAULT_TIMEOUT_S)


def _launch_markers() -> bool:
    """The env a launcher (``torchrun``, :mod:`.launch`) gives each rank."""
    return bool(os.environ.get("MASTER_ADDR")) and bool(os.environ.get("WORLD_SIZE"))


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This rank's device: ``"cuda"`` is ``cuda:{LOCAL_RANK}`` (and raises
    on a host without CUDA, or with too few cards), an indexed
    ``"cuda:N"`` is that card for every rank (ranks sharing a card), and
    ``"cpu"`` the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by default; "
            "pass device='cpu' (--device cpu) for a CPU world"
        )
    if device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} needs cuda:{local}, have {torch.cuda.device_count()} card(s)"
            )
        device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """The backend that follows the device: NCCL on the card, gloo on the
    CPU, unless the caller names one."""
    if backend is not None:
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def join_world(
    address: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> torch.device:
    """``dist.init_process_group`` from arguments, else the launch env
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with
    neither, a world of one on a free local port.  A world that exists
    already is kept, and its size must match.  ``timeout_s`` defaults to
    :func:`world_timeout_s`.  Returns this rank's device."""
    dev = rank_device(device)
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if dist.is_initialized():
        if world_size is not None and dist.get_world_size() != int(world_size):
            raise RuntimeError(
                f"a world of {dist.get_world_size()} exists; asked to join one of {world_size}"
            )
        return dev
    if address is None:
        if os.environ.get("MASTER_ADDR"):
            address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        else:
            from .launch import free_port

            address, world_size, rank = f"tcp://localhost:{free_port()}", 1, 0
    elif "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend=backend_for(dev, backend), init_method=address,
        world_size=int(world_size if world_size is not None else 1),
        rank=int(rank if rank is not None else 0),
        timeout=datetime.timedelta(seconds=float(world_timeout_s() if timeout_s is None
                                                 else timeout_s)),
    )
    return dev


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    require: bool = False,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the multi-process world.  The decision to join is made from
    explicit arguments or the environment markers only; returns False
    when nothing signals a multi-process launch."""
    global _initialized
    if _initialized:
        return True
    explicit = require or coordinator_address is not None or num_processes is not None
    env_opt_in = any(os.environ.get(k) for k in _ENV_MARKERS) or _launch_markers()
    if not (explicit or env_opt_in):
        logger.debug("no multi-process markers: skipping distributed init")
        return False
    dev = join_world(coordinator_address, num_processes, process_id, device, backend, timeout_s)
    _initialized = True
    logger.info("multihost: process %d/%d on %s (%s)", dist.get_rank(), dist.get_world_size(),
                dev, dist.get_backend())
    return True


def is_primary() -> bool:
    """True on the process that writes checkpoints, archives and metrics."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of a global batch."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)
