"""The port's mesh and multihost layer (``memvul_tpu_torch.parallel.mesh``
and ``.multihost``) on gloo worlds of CPU processes, against the JAX
package's ``create_mesh``/``shard_batch``/``local_batch_slice`` rules:
the axes' layout and groups, ``-1`` inference and the device-count error,
``shard_batch`` on either batch axis (scalars, metadata and arrays without
the batch axis whole, an indivisible batch refused), ``replicate``, the exact block
gather, ``local_batch_slice`` and its error, a two-rank reduction through
``multihost.initialize`` (the counterpart of ``test_multihost_dcn.py``),
and ``initialize`` as a no-op without markers."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).parent


def mesh_cases():
    """One rank of a 4-rank world: every mesh rule, results as JSON."""
    import torch.distributed as dist

    from memvul_tpu_torch.parallel import create_mesh, multihost, replicate, shard_batch
    from memvul_tpu_torch.parallel.mesh import any_rank, broadcast_object, gather_blocks

    torch.set_num_threads(1)
    out = {}
    mesh = create_mesh({"data": 2, "model": -1}, device="cpu")
    out["shape"] = mesh.shape
    out["coords"] = mesh.coords
    out["backend"] = mesh.backend
    # each axis's group: a sum over "data" adds the two ranks sharing a model index
    t = torch.tensor([float(mesh.rank)])
    dist.all_reduce(t, group=mesh["data"])
    out["data_sum"] = float(t)
    t = torch.tensor([float(mesh.rank)])
    dist.all_reduce(t, group=mesh["model"])
    out["model_sum"] = float(t)
    try:
        create_mesh({"data": 8}, device="cpu")
    except ValueError as e:
        out["size_error"] = str(e)
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "meta": [{"a": 1}] * 8, "n": 5,
             "t": torch.arange(8)}
    local = shard_batch(batch, mesh)
    out["x"] = local["x"].tolist()
    out["t"] = local["t"].tolist()
    out["meta_len"] = len(local["meta"])
    out["n"] = local["n"]
    stack = np.arange(2 * 8).reshape(2, 8)
    out["stack"] = shard_batch(stack, mesh, batch_axis=1).tolist()
    out["scalar_axis1"] = shard_batch(np.arange(4), mesh, batch_axis=1).tolist()
    try:
        shard_batch(np.arange(7), mesh)
    except ValueError as e:
        out["divide_error"] = str(e)
    module = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(module.weight, float(mesh.rank))
    replicate(module, mesh)
    out["replicated"] = float(module.weight.sum())
    block = torch.full((2, 3), float(mesh.rank))
    out["gathered"] = gather_blocks(block, mesh).tolist()
    out["any"] = any_rank(mesh.rank == 3, mesh)
    out["object"] = broadcast_object({"from": mesh.rank}, mesh)
    s = multihost.local_batch_slice(8)
    out["slice"] = [s.start, s.stop]
    try:
        multihost.local_batch_slice(10)
    except ValueError as e:
        out["slice_error"] = str(e)
    out["primary"] = multihost.is_primary()
    out["multihost_initialized"] = multihost._initialized  # a launched world is no multihost one
    return out


def multihost_reduction(port: int):
    """One rank of a 2-rank world joined through ``multihost.initialize``
    with explicit arguments: the global sum of each rank's shard."""
    import torch.distributed as dist

    from memvul_tpu_torch.parallel import multihost

    joined = multihost.initialize(f"localhost:{port}", num_processes=2,
                                  process_id=int(__import__("os").environ["RANK"]), device="cpu")
    shard = torch.arange(4.0) + 4 * multihost.process_index()
    total = shard.sum()
    dist.all_reduce(total)
    return {"joined": joined, "initialized": multihost._initialized,
            "count": multihost.process_count(), "total": float(total),
            "primary": multihost.is_primary()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from memvul_tpu_torch.parallel.launch import run_ranks

    return run_ranks("test_torch_mesh:mesh_cases", 4, tmp_path_factory.mktemp("mesh"),
                     timeout_s=90, env={"OMP_NUM_THREADS": "1"}, python_path=[HERE])


def test_axes_layout_and_groups(world):
    for rank, res in enumerate(world):
        assert res["shape"] == {"data": 2, "model": 2}  # -1 inferred from 4 ranks
        assert res["coords"] == {"data": rank // 2, "model": rank % 2}  # row-major, as JAX's
        assert res["backend"] == "gloo"  # the CPU's backend
        assert res["data_sum"] == [2.0, 4.0][rank % 2]  # ranks {0, 2} and {1, 3}
        assert res["model_sum"] == [1.0, 5.0][rank // 2]  # ranks {0, 1} and {2, 3}


def test_create_mesh_refuses_a_size_the_world_lacks(world):
    import jax

    from memvul_tpu.parallel import create_mesh as jax_create_mesh

    with pytest.raises(ValueError) as jerr:
        jax_create_mesh({"data": 8}, devices=jax.devices()[:4])
    for res in world:
        assert res["size_error"] == str(jerr.value) == "mesh axes {'data': 8} need 8 devices, have 4"


def test_shard_batch_rules(world):
    for rank, res in enumerate(world):
        i = rank // 2  # the data index; the model axis holds the same rows
        assert res["x"] == np.arange(24).reshape(8, 3)[i * 4:(i + 1) * 4].tolist()
        assert res["t"] == list(range(i * 4, (i + 1) * 4))
        assert res["meta_len"] == 8 and res["n"] == 5  # metadata and scalars pass whole
        assert res["stack"] == np.arange(16).reshape(2, 8)[:, i * 4:(i + 1) * 4].tolist()
        assert res["scalar_axis1"] == [0, 1, 2, 3]  # ndim <= batch_axis: whole
        assert "not divisible by the data axis (2)" in res["divide_error"]


def test_replicate_gather_and_broadcast(world):
    for res in world:
        assert res["replicated"] == 0.0  # rank 0's weights everywhere
        got = np.asarray(res["gathered"])
        assert got.shape == (4, 6)  # [data·2, model·3]
        for d in range(2):
            for m in range(2):
                assert (got[d * 2:(d + 1) * 2, m * 3:(m + 1) * 3] == 2 * d + m).all()
        assert res["any"] is True
        assert res["object"] == {"from": 0}


def test_local_batch_slice_matches_jax_rule(world):
    for rank, res in enumerate(world):
        assert res["slice"] == [rank * 2, rank * 2 + 2]
        assert res["slice_error"] == "global batch 10 not divisible by 4 hosts"
        assert res["primary"] is (rank == 0)
        assert res["multihost_initialized"] is False


def test_two_rank_reduction_through_multihost_initialize(tmp_path):
    from memvul_tpu_torch.parallel.launch import free_port, run_ranks

    results = run_ranks("test_torch_mesh:multihost_reduction", 2, tmp_path,
                        {"port": free_port()}, timeout_s=90,
                        env={"OMP_NUM_THREADS": "1"}, python_path=[HERE])
    for rank, res in enumerate(results):
        assert res == {"joined": True, "initialized": True, "count": 2,
                       "total": float(sum(range(8))), "primary": rank == 0}


def test_initialize_is_a_no_op_without_markers(monkeypatch):
    import torch.distributed as dist

    from memvul_tpu_torch.parallel import multihost

    for key in ("MEMVUL_MULTIHOST", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize() is False
    assert not dist.is_initialized() and multihost._initialized is False
    assert multihost.process_count() == 1 and multihost.is_primary()
    assert multihost.local_batch_slice(8) == slice(0, 8)


def test_create_mesh_refuses_a_host_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from memvul_tpu_torch.parallel import create_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh({"data": 1}, device="cuda:0")


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
