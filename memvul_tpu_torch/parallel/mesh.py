"""The device mesh over a ``torch.distributed`` world (the JAX package's
``parallel/mesh.py``).

JAX drives every device of a mesh from one controller; the port runs one
process per card.  A :class:`Mesh` is the world's ranks laid out
row-major over named axes, each axis with its process groups:

  ``data``   the batch dimension: every rank reads the same inputs and
             keeps its slice (:func:`shard_batch`), gradients are summed
             over it;
  ``model``  tensor parallelism (:mod:`.sharding`) and the scorer's
             sharded anchor bank;
  ``seq``    the sequence axis of ring attention (:mod:`.ring`).

Rank ``r`` owns ``cuda:{LOCAL_RANK}`` (NCCL), or the CPU (gloo).  The
collectives here are all reductions and broadcasts: a gather is a sum of
zero buffers with each rank's block in its own slot, which is exact and
which every backend carries, gloo on CUDA tensors included.  A mesh
keeps the timeout its world was joined with (``timeout_s``), which
bounds every collective's wait.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .multihost import join_world, world_timeout_s

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


class Mesh:
    """The world's ranks over named axes.  ``shape`` maps each axis to its
    size (JAX's ``mesh.shape``), ``mesh[axis]`` is this rank's process
    group along ``axis``, :meth:`index` this rank's coordinate on it."""

    def __init__(self, axes: Dict[str, int], device: torch.device,
                 timeout_s: Optional[float] = None) -> None:
        self.shape: Dict[str, int] = dict(axes)
        self.timeout_s = float(world_timeout_s() if timeout_s is None else timeout_s)
        self.axis_names = tuple(axes)
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        sizes = list(axes.values())
        coords = np.unravel_index(self.rank, sizes) if sizes else ()
        self.coords = {name: int(c) for name, c in zip(self.axis_names, coords)}
        self._groups: Dict[str, Any] = {}
        grid = np.arange(self.world_size).reshape(sizes)
        # every rank makes every group, in the same order (new_group's rule)
        for axis_i, name in enumerate(self.axis_names):
            moved = np.moveaxis(grid, axis_i, -1).reshape(-1, sizes[axis_i])
            for ranks in moved:
                group = dist.new_group([int(r) for r in ranks])
                if self.rank in ranks:
                    self._groups[name] = group

    def __getitem__(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device}, {self.backend})"

    def size(self, axis: str) -> int:
        """The axis's size, 1 for an axis the mesh lacks."""
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def create_mesh(
    axes: Optional[Dict[str, int]] = None,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> Mesh:
    """A mesh over the world, joined first if it does not exist (from the
    launch env, else a world of one); the default is 1-D data parallelism
    over every rank.  ``axes`` maps axis name → size; the sizes must
    multiply to the world size (a -1 size is inferred).  ``device``:
    ``"cuda"`` puts rank r on ``cuda:{LOCAL_RANK}`` and raises without
    CUDA; ``"cuda:N"`` puts every rank on card N (ranks sharing a card,
    which needs ``backend="gloo"``); ``"cpu"`` a gloo world of CPU
    processes.  The backend follows the device unless named; the world's
    timeout is ``timeout_s``, else :func:`~.multihost.world_timeout_s`."""
    if timeout_s is None:
        timeout_s = world_timeout_s()
    dev = join_world(device=device, backend=backend, timeout_s=timeout_s)
    n = dist.get_world_size()
    axes = dict(axes or {DATA_AXIS: n})
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
        axes = dict(zip(axes.keys(), sizes))
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    return Mesh(axes, dev, timeout_s)


def auto_mesh(mesh: Optional[Mesh], use_mesh: bool, device) -> Optional[Mesh]:
    """``mesh``; else, with ``use_mesh``, a data mesh over a joined world
    of several ranks (the JAX package's automatic mesh over its devices);
    else None."""
    if mesh is None and use_mesh and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = create_mesh(device=device)
    return mesh


def batch_spec(mesh: Mesh) -> tuple:
    """The leading (batch) dim's axis: ``("data",)`` when the mesh has
    that axis, else ``()`` (replicated), as JAX's ``P("data")``/``P()``."""
    return (DATA_AXIS,) if DATA_AXIS in mesh.axis_names else ()


def _slice_rows(x, n_shards: int, i: int, axis: int):
    size = x.shape[axis]
    if size % n_shards:
        raise ValueError(
            f"batch dimension {size} (axis {axis}) not divisible by the data axis ({n_shards})"
        )
    per = size // n_shards
    index = [slice(None)] * x.ndim
    index[axis] = slice(i * per, (i + 1) * per)
    return x[tuple(index)]


def shard_batch(batch, mesh: Mesh, batch_axis: int = 0):
    """This rank's contiguous slice of every array of ``batch`` (nested
    dicts, lists and tuples) along ``batch_axis``, over the ``data`` axis;
    arrays with ``ndim <= batch_axis``, scalars and non-arrays (metadata)
    pass through whole.  ``batch_axis=1`` shards a [K, B, ...] microbatch
    stack on its B dimension.  A batch whose size does not divide the data
    axis raises."""
    n, i = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > batch_axis and n > 1:
            return _slice_rows(x, n, i, batch_axis)
        return x

    return put(batch)


def replicate(tree, mesh: Mesh, src: int = 0):
    """Broadcast a module's parameters and buffers, or the tensors of a
    nested dict or list, from rank ``src`` to every rank (in place);
    returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors: List[torch.Tensor] = [t.data for t in itertools.chain(tree.parameters(), tree.buffers())]
    else:
        tensors = []

        def collect(x):
            if isinstance(x, dict):
                for v in x.values():
                    collect(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    collect(v)
            elif isinstance(x, torch.Tensor):
                tensors.append(x)

        collect(tree)
    if mesh.world_size > 1:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src)
    return tree


# -- collectives the data-parallel paths share --------------------------------


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over ``group`` in place, through one flat buffer per
    dtype (one collective per dtype)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_data(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh],
                    model_copies: bool = True) -> None:
    """Sum each tensor over the ``data`` axis in place: one all-reduce over
    this rank's data group.  With ``model_copies`` and a ``model`` axis,
    the ranks of that axis hold copies (the trainers' replication), which
    must stay equal bit for bit, and two data groups summing alike is not
    guaranteed (a backward's scatter-adds may order their sums differently
    on two copies): the copies at model index > 0 contribute zeros to one
    all-reduce over the whole world, so every rank gets model copy 0's sum.
    A tensor-parallel model (``model_copies`` false) holds different shards
    on its model ranks, summed over ``data`` alone."""
    if mesh is None or mesh.world_size == 1:
        return
    if model_copies and mesh.size(MODEL_AXIS) > 1:
        if mesh.index(MODEL_AXIS) > 0:
            for t in tensors:
                t.zero_()
        all_reduce_sum(tensors)
    elif mesh.size(DATA_AXIS) > 1:
        all_reduce_sum(tensors, mesh[DATA_AXIS])


def gather_blocks(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``[b, a, ...]`` block → the whole ``[data·b, model·a,
    ...]`` array on every rank: rows in data order, columns (the anchor
    bank's shards) in model order.  A sum of zero buffers with each block
    in its rank's slot, so the result is exact."""
    d, m = mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS)
    if mesh.world_size == 1:
        return local
    if d * m != mesh.world_size:
        raise ValueError(f"gather_blocks needs a data × model mesh, got {mesh.shape}")
    buf = local.new_zeros((d, m) + tuple(local.shape))
    buf[mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS)] = local
    dist.all_reduce(buf)
    b, a = local.shape[:2]
    return buf.transpose(1, 2).reshape((d * b, m * a) + tuple(local.shape[2:]))


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """``obj`` from rank ``src`` on every rank (pickled)."""
    if mesh.world_size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=mesh.device)
    return box[0]


def broadcast_header(values: Optional[Sequence[int]], length: int, mesh: Mesh) -> List[int]:
    """A fixed-size header of ``length`` int64s from rank 0 on every rank:
    ``values`` (zero-padded) on rank 0, ignored elsewhere."""
    t = torch.zeros(length, dtype=torch.int64, device=mesh.device)
    if mesh.is_primary:
        if len(values) > length:
            raise ValueError(f"a header of {len(values)} values exceeds {length}")
        t[: len(values)] = torch.tensor(list(values), dtype=torch.int64)
    dist.broadcast(t, 0)
    return [int(v) for v in t.tolist()]


def broadcast_tensor(tensor: Optional[torch.Tensor], shape: Sequence[int], dtype: torch.dtype,
                     mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``tensor`` (of ``shape`` and ``dtype``) on every rank, on
    the mesh's device; the other ranks pass None and allocate it."""
    if mesh.is_primary:
        t = tensor.to(device=mesh.device, dtype=dtype).contiguous()
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"broadcast of shape {tuple(t.shape)}, announced {tuple(shape)}")
    else:
        t = torch.empty(tuple(shape), dtype=dtype, device=mesh.device)
    dist.broadcast(t, 0)
    return t


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is true on any."""
    if mesh.world_size == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)
