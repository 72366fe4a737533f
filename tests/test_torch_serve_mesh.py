"""One scoring service across the ranks of a mesh (``serve --mesh``), and
training on a ``model`` axis, on gloo worlds of CPU processes, held
against the JAX package and the single-process port on one tiny archive:

* a ``data=2 × model=2`` service (rank 0 serves, ranks 1-3 follow it)
  scores as the JAX package's ``serve_from_archive`` on a ``data=2,
  model=2`` mesh of 4 virtual CPU devices (rtol 1e-4 / atol 1e-5), before
  and after a swap, made mid-traffic, to a 7-anchor bank that the model
  axis does not divide, and for a named tenant's bank; a swap that fails
  on one rank leaves the old bank serving on every rank, a replaced bank
  is dropped on every rank, and the int8 tier scores through the same
  channel;
* ``data=1 × model=2`` is bitwise the single-process service, before and
  after an idle gap longer than its world's (shortened) timeout;
* a drain ends every rank with exit 0; a SIGKILLed follower ends the
  world with a non-zero exit; ``serve --mesh data=2 --device cpu`` over
  HTTP;
* the refusals and their JAX messages, and the automatic mesh decision;
* training on ``data=2 × model=2`` (``build.train_from_config``) and
  ``train --mesh data=1,model=2``: losses and params within f32 1e-5 of
  one process, every model copy bitwise equal after each step, and the
  JAX ``MemoryTrainer`` on a ``data=2, model=2`` mesh within 1e-4;
  ``ClassifierTrainer`` on ``data=1 × model=2``.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).parent
ROOT = HERE.parent
SERVING = {"max_length": 48, "max_batch": 8, "buckets": [16, 48], "default_deadline_ms": 60000}
# the idle world's timeout, and its idle gap past it
IDLE_TIMEOUT_S = 8.0
IDLE_S = 11.0
TOL = dict(rtol=1e-4, atol=1e-5)


# -- what each rank runs --------------------------------------------------------------


def _instances(path):
    from memvul_tpu_torch.data.readers import MemoryReader

    return list(MemoryReader().read_anchors(str(path)))


def _responses(service, texts, tenant=None):
    """Each text's response (status, bank version, probabilities)."""
    futures = [service.submit(t, tenant=tenant) for t in texts]
    return [_slim(f.result(timeout=120)) for f in futures]


def _slim(response):
    return {"status": response["status"], "bank_version": response.get("bank_version"),
            "predict": response.get("predict")}


def _digest(module) -> str:
    h = hashlib.sha256()
    for p in module.parameters():
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _hooked_steps(module_name: str, fn_name: str, digests: list):
    """Wrap a trainer module's step function: each step's params digest."""
    import importlib

    module = importlib.import_module(module_name)
    original = getattr(module, fn_name)

    def step(model, *args, **kwargs):
        stats = original(model, *args, **kwargs)
        digests.append(_digest(model))
        return stats

    setattr(module, fn_name, step)
    return lambda: setattr(module, fn_name, original)


def _train_losses(result):
    return [x for epoch in result["history"] for x in epoch["training_losses"]]


def serve_d2m2_world(archive, texts, swap, tenant, broken, anchors, train_cfg, work):
    """One rank of a ``data=2 × model=2`` world: the service (a swap
    mid-traffic, a tenant, a swap that fails on rank 3 alone), the int8
    tier through the channel, then the memory trainer on the same mesh."""
    from memvul_tpu_torch import build
    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor
    from memvul_tpu_torch.parallel import create_mesh
    from memvul_tpu_torch.serving.mesh import MeshLeader, follow

    torch.set_num_threads(1)
    mesh = create_mesh({"data": 2, "model": 2}, device="cpu")
    out = {"rank": mesh.rank}
    target = build.serve_from_archive(archive, device="cpu", mesh=mesh)
    if mesh.is_primary:
        service = target
        out["v1"] = _responses(service, texts)
        during, stop = [], threading.Event()

        def traffic(i):
            while not stop.is_set():
                during.extend(zip(range(i, len(texts), 4), _responses(service, texts[i::4])))

        with ThreadPoolExecutor(4) as pool:
            clients = [pool.submit(traffic, i) for i in range(4)]
            time.sleep(0.3)
            out["swap_version"] = service.swap_bank(_instances(swap))
            out["after"] = _responses(service, texts)
            stop.set()
            for c in clients:
                c.result()
        out["during"] = during
        service.swap_bank(_instances(tenant), tenant="acme")
        out["acme"] = _responses(service, texts, tenant="acme")
        out["shard_rows"] = int(service.bank_snapshot().array.shape[0])
        try:
            service.swap_bank(_instances(broken))
        except Exception as e:
            out["broken_swap"] = type(e).__name__
        out["after_broken"] = _responses(service, texts)
        # replacing the default bank frees its shard: dropped on every rank
        service.swap_bank(_instances(tenant))
        out["after_replace"] = _responses(service, texts)
        out["commands"] = dict(service.predictor.channel.commands)
        service.drain()
    else:
        if mesh.rank == 3:
            # this rank alone fails to encode the 3-anchor bank
            encode = target.predictor._encode_rows

            def failing(block):
                if int(block["attention_mask"].any(axis=1).sum()) == 3:
                    raise RuntimeError("injected encode failure")
                return encode(block)

            target.predictor._encode_rows = failing
        out["follower"] = target.run()
    # the int8 tier: every rank builds the predictor, rank 0 drives it
    arch = load_archive(archive, device="cpu")
    predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48,
                                 buckets=[16, 48], encoder_precision="int8", mesh=mesh)
    predictor.encode_anchors(_instances(anchors))
    if mesh.is_primary:
        predictor.channel = MeshLeader(mesh, predictor)
        try:
            out["int8"] = predictor.score_texts(texts, impl="int8").tolist()
        finally:
            predictor.channel.stop()
    else:
        out["int8_follower"] = follow(mesh, predictor)
    # the memory trainer on the same mesh, each step's params digested
    digests: list = []
    restore = _hooked_steps("memvul_tpu_torch.training.trainer", "train_step", digests)
    try:
        result = build.train_from_config(train_cfg, Path(work) / "train", device="cpu", mesh=mesh)
    finally:
        restore()
    out["losses"], out["digests"] = _train_losses(result), digests
    return out


def serve_d1m2_world(archive, texts, idle_s, single_cfg, work):
    """One rank of a ``data=1 × model=2`` world with a short timeout: the
    service before and after an idle gap past it, then the classifier
    trainer on the same mesh."""
    from memvul_tpu_torch import build
    from memvul_tpu_torch.parallel import create_mesh

    torch.set_num_threads(1)
    mesh = create_mesh({"data": 1, "model": 2}, device="cpu")
    out = {"rank": mesh.rank, "timeout_s": mesh.timeout_s}
    target = build.serve_from_archive(archive, device="cpu", mesh=mesh)
    if mesh.is_primary:
        out["before"] = _responses(target, texts)
        time.sleep(idle_s)
        out["after"] = _responses(target, texts)
        out["commands"] = dict(target.predictor.channel.commands)
        target.drain()
    else:
        out["follower"] = target.run()
    digests: list = []
    restore = _hooked_steps("memvul_tpu_torch.training.single_trainer", "classifier_step", digests)
    try:
        result = build.train_from_config(single_cfg, Path(work) / "single", device="cpu", mesh=mesh)
    finally:
        restore()
    out["losses"], out["digests"] = _train_losses(result), digests
    return out


# -- the fixtures: every world and CLI run starts at once ---------------------------------


def _cli(*argv):
    return subprocess.Popen(
        [sys.executable, "-m", "memvul_tpu_torch", *map(str, argv)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def _http_score(url, texts):
    out = []
    for text in texts:
        req = urllib.request.Request(url + "/score", data=json.dumps({"text": text}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out.append(_slim(json.loads(r.read())))
    return out


def _serve_cli_run(archive, texts, out_dir, kill_follower: bool):
    """``serve --mesh data=2 --device cpu``: its responses over HTTP, then
    SIGTERM to rank 0 (or SIGKILL to rank 1); the exit code and wall."""
    proc = _cli("serve", archive, "--mesh", "data=2", "--device", "cpu", "--port", "0",
                "-o", out_dir)
    line = json.loads(proc.stdout.readline())
    result = {"line": line, "responses": _http_score(line["serving"], texts)}
    t0 = time.monotonic()
    if kill_follower:
        os.kill(line["rank_pids"][1], signal.SIGKILL)
    else:
        proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=90)
    result.update(rc=proc.returncode, exit_s=time.monotonic() - t0, err=err[-3000:])
    return result


def _memory_cfg(paths):
    from memvul_tpu_torch.data.synthetic import selfcheck_config

    cfg = selfcheck_config({"paths": paths}, batch_size=4, grad_accum=2, steps_per_epoch=3)
    cfg["model"]["encoder"].update(hidden_dropout=0.0, attention_dropout=0.0)
    return cfg


def _single_cfg(paths):
    return {
        "random_seed": 2021,
        "tokenizer": {"type": "wordpiece", "tokenizer_path": paths["tokenizer"]},
        "dataset_reader": {"type": "reader_single", "sample_neg": 0.5},
        "train_data_path": paths["train"], "validation_data_path": paths["validation"],
        "model": {"type": "model_single", "header_dim": 32,
                  "encoder": {"preset": "tiny", "hidden_dropout": 0.0, "attention_dropout": 0.0}},
        "trainer": {"num_epochs": 1, "steps_per_epoch": 3, "batch_size": 6, "max_length": 48,
                    "eval_batch_size": 8, "eval_max_length": 48},
    }


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A tiny archive (JAX-initialised weights), its test texts, the swap
    and tenant banks, the training configs."""
    import jax

    from memvul_tpu import archive as jax_archive
    from memvul_tpu.data.synthetic import build_workspace
    from memvul_tpu.models import BertConfig as JaxBertConfig
    from memvul_tpu.models import MemoryModel as JaxMemoryModel
    from memvul_tpu_torch.data.readers import MemoryReader

    work = tmp_path_factory.mktemp("serve_mesh")
    ws = build_workspace(work / "ws", seed=11)
    paths = ws["paths"]
    vocab = ws["tokenizer"].vocab_size
    cfg = JaxBertConfig.tiny(vocab_size=vocab, scan_layers=True)
    dummy = {"input_ids": np.zeros((2, 8), np.int32), "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.device_get(JaxMemoryModel(cfg, header_dim=32).init(jax.random.PRNGKey(0), dummy,
                                                                   dummy))
    config = {
        "tokenizer": {"type": "wordpiece"},
        "dataset_reader": {"type": "reader_memory", "cve_path": paths["cve"],
                           "anchor_path": paths["anchors"]},
        "model": {"type": "model_memory", "header_dim": 32,
                  "encoder": {"preset": "tiny", "vocab_size": vocab, "scan_layers": True}},
        "serving": SERVING,
    }
    archive = jax_archive.save_archive(work / "model.tar.gz", config, params,
                                       tokenizer_file=paths["tokenizer"])
    bank = json.loads(Path(paths["anchors"]).read_text())
    assert len(bank) == 8
    swap, tenant, broken = work / "swap.json", work / "tenant.json", work / "broken.json"
    # 7 anchors: shards of 4 and 3 (+1 zero row) over model=2
    swap.write_text(json.dumps({k: v + " revised" for k, v in list(bank.items())[:7]}))
    tenant.write_text(json.dumps(dict(list(bank.items())[3:8])))
    broken.write_text(json.dumps(dict(list(bank.items())[:3])))
    reader = MemoryReader(cve_path=paths["cve"], anchor_path=paths["anchors"])
    texts = [inst["text1"] for inst in reader.read(paths["test"], split="test")][:24]
    return {"work": work, "paths": paths, "archive": str(archive), "texts": texts,
            "swap": str(swap), "tenant": str(tenant), "broken": str(broken)}


@pytest.fixture(scope="module")
def started(env):
    """Every world and CLI run, started at once in the background."""
    from memvul_tpu_torch.parallel.launch import run_ranks

    work, paths, texts = env["work"], env["paths"], env["texts"]
    train_cfg = work / "memory.json"
    train_cfg.write_text(json.dumps(_memory_cfg(paths)))
    pool = ThreadPoolExecutor(6)
    runs = {
        "d2m2": pool.submit(
            run_ranks, "test_torch_serve_mesh:serve_d2m2_world", 4, work / "d2m2",
            {"archive": env["archive"], "texts": texts, "swap": env["swap"],
             "tenant": env["tenant"], "broken": env["broken"], "anchors": paths["anchors"],
             "train_cfg": _memory_cfg(paths), "work": str(work / "d2m2")},
            timeout_s=240, env={"OMP_NUM_THREADS": "1"}, python_path=[HERE]),
        "d1m2": pool.submit(
            run_ranks, "test_torch_serve_mesh:serve_d1m2_world", 2, work / "d1m2",
            {"archive": env["archive"], "texts": texts, "idle_s": IDLE_S,
             "single_cfg": _single_cfg(paths), "work": str(work / "d1m2")},
            timeout_s=240, env={"OMP_NUM_THREADS": "1", "MEMVUL_WORLD_TIMEOUT_S": str(IDLE_TIMEOUT_S)},
            python_path=[HERE]),
        "cli_drain": pool.submit(_serve_cli_run, env["archive"], texts[:8], work / "cli_drain",
                                 False),
        "cli_kill": pool.submit(_serve_cli_run, env["archive"], texts[:4], work / "cli_kill",
                                True),
    }
    train = _cli("train", train_cfg, "-s", work / "cli_train", "--mesh", "data=1,model=2",
                 "--device", "cpu")
    runs["cli_train"] = pool.submit(lambda: (train.communicate(timeout=240), train.returncode))
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def d2m2(started):
    return started["d2m2"].result()


@pytest.fixture(scope="module")
def d1m2(started):
    return started["d1m2"].result()


@pytest.fixture(scope="module")
def single(env, started):
    """The single-process port's answers: the service before and after the
    swap, the tenant, the int8 tier; the trainers' runs."""
    from memvul_tpu_torch import build
    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        texts = env["texts"]
        service = build.serve_from_archive(env["archive"], device="cpu")
        out = {"v1": _responses(service, texts)}
        service.swap_bank(_instances(env["swap"]))
        out["v2"] = _responses(service, texts)
        service.drain()
        arch = load_archive(env["archive"], device="cpu")
        predictor = SiamesePredictor(arch.model, arch.tokenizer, batch_size=8, max_length=48,
                                     buckets=[16, 48], encoder_precision="int8")
        predictor.encode_anchors(_instances(env["paths"]["anchors"]))
        out["int8"] = predictor.score_texts(texts, impl="int8")
        work = env["work"] / "one"
        out["memory"] = _train_losses(build.train_from_config(
            _memory_cfg(env["paths"]), work / "memory", device="cpu"))
        out["single"] = _train_losses(build.train_from_config(
            _single_cfg(env["paths"]), work / "single", device="cpu"))
        out["dirs"] = {"memory": work / "memory", "single": work / "single"}
    finally:
        torch.set_num_threads(previous)
    return out


@pytest.fixture(scope="module")
def jax_service(env, started):
    """The JAX package's service on a ``data=2, model=2`` mesh of 4 CPU
    devices: the texts against the startup bank, after the same swap, and
    for the same tenant."""
    import jax

    from memvul_tpu.build import serve_from_archive as jax_serve
    from memvul_tpu.data.readers import MemoryReader as JaxReader
    from memvul_tpu.parallel import create_mesh as jax_mesh

    texts = env["texts"]
    service = jax_serve(env["archive"], mesh=jax_mesh({"data": 2, "model": 2},
                                                      devices=jax.devices()[:4]))
    try:
        out = {"v1": _responses(service, texts)}
        service.swap_bank(list(JaxReader().read_anchors(env["swap"])))
        out["v2"] = _responses(service, texts)
        service.swap_bank(list(JaxReader().read_anchors(env["tenant"])), tenant="acme")
        out["acme"] = _responses(service, texts, tenant="acme")
    finally:
        service.drain()
    return out


def _assert_close(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["status"] == w["status"] == "ok"
        assert list(g["predict"]) == list(w["predict"])
        if exact:
            assert g["predict"] == w["predict"]
        else:
            np.testing.assert_allclose(list(g["predict"].values()), list(w["predict"].values()),
                                       **TOL)


# -- serving on a mesh ------------------------------------------------------------------


def test_data2_model2_service_matches_the_jax_sharded_service(d2m2, jax_service):
    leader = d2m2[0]
    _assert_close(leader["v1"], jax_service["v1"])
    assert {r["bank_version"] for r in leader["v1"]} == {1}
    # every rank ran every command; the followers wrote nothing
    assert all(r["follower"]["stop"] == 1 for r in d2m2[1:])
    assert all(r["follower"]["score"] == leader["commands"]["score"] for r in d2m2[1:])


def test_swap_mid_traffic_to_an_indivisible_bank_matches_jax(d2m2, jax_service, env):
    leader = d2m2[0]
    assert leader["swap_version"] == 2
    assert leader["shard_rows"] == 4  # 7 anchors over model=2: 4 and 3 + a zero row
    # after the flip every response is the new bank's, as JAX's after the same swap
    assert {r["bank_version"] for r in leader["after"]} == {2}
    _assert_close(leader["after"], jax_service["v2"])
    # during the swap no request is lost, and each answer is its version's
    assert leader["during"] and all(r["status"] == "ok" for _, r in leader["during"])
    for i, response in leader["during"]:
        want = jax_service["v1" if response["bank_version"] == 1 else "v2"][i]
        _assert_close([response], [want])
    # every install reached every rank (the swap, the tenant, a failed one, a replacement)
    assert all(r["follower"]["install"] == leader["commands"]["install"] == 4 for r in d2m2[1:])


def test_a_named_tenant_bank_serves_on_the_mesh(d2m2, jax_service):
    leader = d2m2[0]
    assert {r["bank_version"] for r in leader["acme"]} == {1}
    assert len(leader["acme"][0]["predict"]) == 5
    _assert_close(leader["acme"], jax_service["acme"])


def test_a_swap_failing_on_one_rank_leaves_the_old_bank_on_every_rank(d2m2):
    leader = d2m2[0]
    assert leader["broken_swap"] == "BankInstallError"
    # the 7-anchor bank still serves, with the same answers, on every rank
    assert {r["bank_version"] for r in leader["after_broken"]} == {2}
    _assert_close(leader["after_broken"], leader["after"], exact=True)
    assert all(r["follower"]["install"] == leader["commands"]["install"] for r in d2m2[1:])


def test_a_replaced_bank_is_dropped_on_every_rank(d2m2):
    leader = d2m2[0]
    assert {r["bank_version"] for r in leader["after_replace"]} == {3}
    assert leader["commands"]["drop"] >= 1
    assert all(r["follower"]["drop"] == leader["commands"]["drop"] for r in d2m2[1:])


def test_int8_tier_runs_through_the_channel(d2m2, single):
    np.testing.assert_allclose(np.asarray(d2m2[0]["int8"]), single["int8"], **TOL)
    assert all(r["int8_follower"]["score_int8"] >= 1 for r in d2m2[1:])


def test_data1_model2_is_bitwise_one_process_before_and_after_idle(d1m2, single):
    leader, follower = d1m2
    assert leader["timeout_s"] == IDLE_TIMEOUT_S < IDLE_S
    _assert_close(leader["before"], single["v1"], exact=True)
    _assert_close(leader["after"], single["v1"], exact=True)
    # the idle gap outlived the world's timeout: keep-alives carried it
    assert leader["commands"]["keepalive"] >= 2
    assert follower["follower"]["keepalive"] == leader["commands"]["keepalive"]


def test_serve_mesh_cli_drains_every_rank_with_exit_0(started, single, env):
    run = started["cli_drain"].result()
    assert run["rc"] == 0, run["err"]
    assert run["line"]["mesh"] == {"data": 2} and len(run["line"]["rank_pids"]) == 2
    _assert_close(run["responses"], single["v1"][:8])
    # rank 1 followed every device call and stopped at rank 0's drain
    log = (env["work"] / "cli_drain" / "rank-1.log").read_text()
    assert "follower rank 1 stopped after" in log and "Traceback" not in log


def test_a_killed_follower_ends_the_world_non_zero(started):
    run = started["cli_kill"].result()
    assert run["rc"] != 0
    assert run["exit_s"] < 30
    assert "rank 1 exited with -9" in run["err"]


# -- the refusals and the automatic mesh ---------------------------------------------------


def test_packed_strategies_and_replicas_refuse_a_mesh_with_the_jax_messages(env):
    from memvul_tpu import archive as jax_archive
    from memvul_tpu.build import serve_from_archive as jax_serve
    from memvul_tpu.evaluate.predict_memory import SiamesePredictor as JaxPredictor
    from memvul_tpu_torch import build
    from memvul_tpu_torch.archive import load_archive
    from memvul_tpu_torch.evaluate.predict_memory import SiamesePredictor

    arch = load_archive(env["archive"], device="cpu")
    jarch = jax_archive.load_archive(env["archive"])
    mesh = types.SimpleNamespace(device=torch.device("cpu"), size=lambda axis: 2)
    for impl in ("ragged", "continuous", "cascade"):
        with pytest.raises(ValueError) as want:
            JaxPredictor(jarch.model, jarch.params, jarch.tokenizer, mesh=object(), score_impl=impl)
        with pytest.raises(ValueError) as got:
            SiamesePredictor(arch.model, arch.tokenizer, mesh=mesh, score_impl=impl)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_serve(env["archive"], mesh=object(), replicas=2)
    with pytest.raises(ValueError) as got:
        build.serve_from_archive(env["archive"], device="cpu", mesh=mesh, replicas=2)
    assert str(got.value) == str(want.value) and "pick one scaling axis" in str(got.value)


@pytest.mark.parametrize("cards,no_mesh,replicas,autoscale,want", [
    (4, False, 1, False, "data=4"),
    (2, False, 1, False, "data=2"),
    (1, False, 1, False, None),
    (0, False, 1, False, None),
    (4, True, 1, False, None),
    (4, False, 2, False, None),
    (4, False, 1, True, None),
])
def test_automatic_serving_mesh_decision(cards, no_mesh, replicas, autoscale, want):
    from memvul_tpu_torch.__main__ import auto_mesh_spec

    assert auto_mesh_spec(cards, no_mesh, replicas, autoscale) == want


def test_hosts_validates_a_mesh_spec_and_ignores_it(capsys):
    from memvul_tpu_torch.__main__ import main

    assert main(["serve", "--hosts", "127.0.0.1:1", "--mesh", "data=x"]) == 2
    assert "invalid literal" in capsys.readouterr().err
    from memvul_tpu_torch.__main__ import _serve_target

    args = types.SimpleNamespace(archive=None, hosts="127.0.0.1:1", mesh="data=2,model=2",
                                 out_dir=None, overrides=None, tsdb_cadence=None, port=0)
    balancer, rc = _serve_target(args)
    try:
        assert rc is None and len(balancer.hosts) == 1
    finally:
        balancer.drain()


# -- training on a model axis ------------------------------------------------------------------


def _params(archive):
    from memvul_tpu_torch.archive import load_archive

    return {k: v.detach().numpy() for k, v in
            load_archive(archive, device="cpu").model.state_dict().items()}


def _assert_params_close(got_archive, want_archive):
    got, want = _params(got_archive), _params(want_archive)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)


def test_memory_trainer_on_data2_model2_matches_one_process(d2m2, single, env):
    for rank in d2m2:
        np.testing.assert_allclose(rank["losses"], single["memory"], rtol=0, atol=1e-5)
    # the four copies hold the same bits after every step
    assert len(d2m2[0]["digests"]) == 3
    assert all(rank["digests"] == d2m2[0]["digests"] for rank in d2m2)
    _assert_params_close(env["work"] / "d2m2" / "train" / "model.tar.gz",
                         single["dirs"]["memory"] / "model.tar.gz")


def test_jax_trainer_on_a_data2_model2_mesh_matches_the_port(d2m2, env, tmp_path):
    import jax

    from memvul_tpu.build import build_model as jax_build_model
    from memvul_tpu.build import build_reader as jax_build_reader
    from memvul_tpu.build import build_tokenizer as jax_build_tokenizer
    from memvul_tpu.parallel import create_mesh as jax_mesh
    from memvul_tpu.training.trainer import MemoryTrainer as JaxTrainer
    from memvul_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
    from memvul_tpu_torch import build
    from memvul_tpu_torch.models.convert import flax_from_params

    cfg = _memory_cfg(env["paths"])
    paths = env["paths"]
    port = build.init_params(build.build_model(cfg["model"], build.build_tokenizer(
        cfg["tokenizer"]).vocab_size), 2021)
    params = flax_from_params({k: v.detach() for k, v in port.state_dict().items()}, port.config)
    tok = jax_build_tokenizer(cfg["tokenizer"])
    log = tmp_path / "jax_losses.jsonl"
    trainer = JaxTrainer(
        jax_build_model(cfg["model"], tok.vocab_size), params, tok,
        jax_build_reader(cfg["dataset_reader"], seed=2021), paths["train"], None,
        paths["anchors"],
        config=JaxTrainerConfig(**dict(cfg["trainer"], seed=2021,
                                       serialization_dir=str(tmp_path / "jax"),
                                       step_loss_log=str(log))),
        mesh=jax_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4]),
    )
    trainer.train()
    want = [json.loads(line)["loss"] for line in log.read_text().splitlines()]
    assert len(want) == len(d2m2[0]["losses"]) == 3
    np.testing.assert_allclose(d2m2[0]["losses"], want, rtol=0, atol=1e-4)


def test_train_cli_on_data1_model2_matches_one_process(started, single, env):
    (out, err), rc = started["cli_train"].result()
    assert rc == 0, err[-3000:]
    run = env["work"] / "cli_train"
    metrics = json.loads((run / "metrics.json").read_text())
    np.testing.assert_allclose(_train_losses(metrics), single["memory"], rtol=0, atol=1e-5)
    _assert_params_close(run / "model.tar.gz", single["dirs"]["memory"] / "model.tar.gz")
    assert len([line for line in out.splitlines() if line.startswith("{")]) == 1
    assert "Traceback" not in (run / "rank-1.log").read_text()


def test_classifier_trainer_on_data1_model2_matches_one_process(d1m2, single, env):
    for rank in d1m2:
        np.testing.assert_allclose(rank["losses"], single["single"], rtol=0, atol=1e-5)
    assert len(d1m2[0]["digests"]) == 3 and d1m2[0]["digests"] == d1m2[1]["digests"]
    _assert_params_close(env["work"] / "d1m2" / "single" / "model.tar.gz",
                         single["dirs"]["single"] / "model.tar.gz")
