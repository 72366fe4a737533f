"""Command-line interface of the PyTorch/CUDA port.

    python -m memvul_tpu_torch pretrain configs/further_pretrain.json [--export-hf]
    python -m memvul_tpu_torch train configs/config_memory.json -s out/
    python -m memvul_tpu_torch train configs/config_single.json -s out_single/
    python -m memvul_tpu_torch evaluate out/model.tar.gz data/test_project.json -o eval/
    python -m memvul_tpu_torch evaluate ... --overrides "$(cat configs/test_config_memory.json)"
    python -m memvul_tpu_torch evaluate ... --overrides '{"evaluation": {"batch_size": 64}}' --device cpu
    python -m memvul_tpu_torch score-corpus out/model.tar.gz data/test_project.json -o eval/ --shards 2
    python -m memvul_tpu_torch serve out/model.tar.gz --port 8341 \\
        --overrides '{"serving": {"score_impl": "continuous"}}'
    python -m memvul_tpu_torch serve out/model.tar.gz --replicas 2 \\
        --tenants acme=banks/acme,globex=banks/globex
    python -m memvul_tpu_torch serve out/model.tar.gz -o run/ --tsdb-cadence 1 --port 0
    python -m memvul_tpu_torch serve --hosts 127.0.0.1:8341,127.0.0.1:8342 --port 8340
    python -m memvul_tpu_torch bank build --store banks/ --anchors data/CWE_anchor_golden_project.json
    python -m memvul_tpu_torch bank diff --store banks/ --retire CWE-79 --reweight CWE-89=0.5
    python -m memvul_tpu_torch bank shadow --store banks/ --candidate v2 --archive out/ \\
        --corpus data/test_project.json --results eval/model_memory_result.json -o shadow/
    python -m memvul_tpu_torch bank promote --store banks/ --candidate v2 --archive out/ \\
        --golden-set data/validation_project.json --shadow-summary shadow/shadow_summary.json
    python -m memvul_tpu_torch bank build --store banks/ --tenant acme --anchors acme.json
    python -m memvul_tpu_torch build-data --csv all_samples.csv --cwe-csv 1000.csv \\
        --cve-dict CVE_dict.json --out data/
    python -m memvul_tpu_torch analyze data/train_project.json --cve-dict CVE_dict.json
    python -m memvul_tpu_torch selfcheck
    python -m memvul_tpu_torch telemetry-report out/ [--json]
    python -m memvul_tpu_torch baseline data/train_project.json data/test_project.json -o baseline_out/
    BENCH_MICRO=serve BENCH_SERVE_IMPL=ab python -m memvul_tpu_torch bench
    python -m memvul_tpu_torch tune --mode all --model base --out profiles/ [--cascade]
    python -m memvul_tpu_torch tune --report out/ [--splice PERF.md]
    python -m memvul_tpu_torch doctor --config configs/config_memory.json [--skip-device]
    python -m memvul_tpu_torch parity --hf-dir bert-base-uncased/ --archive model.tar.gz \\
        --corpus data/test_project.json --anchors data/CWE_anchor_golden_project.json \\
        [--ref-metrics reference_metric.json] [-o parity_out/]
    python -m memvul_tpu_torch lint [--select MV101,MV201] [--json]

``pretrain`` further-pretrains the encoder with whole-word-mask MLM into
``<output_dir>/encoder.msgpack`` (``--export-hf`` adds an HF checkpoint
under ``<output_dir>/hf``) and prints ``final_loss`` and ``checkpoint``
(with a ``validation_data_path``, ``eval_loss`` and ``perplexity``) as one
JSON line.  ``train`` trains the model a config describes (the memory
model, MemVul-m or TextCNN) into a serialization dir (checkpoints,
``metrics.json``, the best weights as ``model.tar.gz``) and prints the
best epoch and its validation metric as one JSON line.
``evaluate`` prints the metric dict as one JSON line.  ``score-corpus``
scores a corpus across supervised worker subprocesses and merges their
outputs exactly once (exit 0 done, 1 the merge verification failed, 2 a
usage error, 3 partial: a shard was quarantined, the refusal printed as
JSON).  ``serve`` puts the HTTP front end (``POST /score``, ``GET
/healthz``, ``GET /metrics``, ``GET /tracez``, ``GET /programz``, ``GET
/metricsz``, ``GET /alertz``, ``POST /profilez``) over
``build.serve_from_archive`` (``--replicas N``: a router over N replicas;
``--tenants name=store_dir,...``: one anchor bank per named tenant;
``--tsdb-cadence S``: the metrics history, the alert rules and, with
``-o``, incident bundles; ``-o`` is also the ``/profilez`` capture root),
or without an archive over a balancer of running serve processes
(``--hosts``, else ``serving.hosts`` of ``--overrides``, whose ``fleet_*``
keys set its supervision); it prints one JSON line with the bound ``"serving"`` URL and
the replica count once it listens, and drains on SIGTERM/SIGINT.
``pretrain``, ``train`` and ``evaluate`` take ``--profile DIR``, a
profiler trace of the whole run.
``bank`` keeps the versioned anchor-bank store (``build``, ``diff``,
``log``; ``--tenant NAME`` scopes each subcommand to ``<store>/<NAME>``,
the layout ``serve --tenants`` points at), replays a recorded run against a candidate bank (``shadow``) and
runs the promotion gate (``promote``: exit 0 approved, 1 refused, 2 a
usage error).  ``build-data`` runs the offline corpus pipeline (splits,
CWE anchors, the MLM corpus), ``analyze`` the paper's corpus analyses, and
``selfcheck`` a synthetic workspace through a tiny ``train``, the archive
and ``evaluate``.  ``telemetry-report`` renders a run dir's sinks
(``events.jsonl``, ``telemetry.json``, ``HEARTBEAT.json``, ``programs.json``,
replica and shard subdirs, incident bundles) as text, or with ``--json``
as the machine-readable report.  ``baseline`` runs the paper's classical
baselines (bag of words, L1-SVC feature selection, RF, NB, MLP, LR, KNN)
without sklearn and writes ``{learner}_result.json`` and
``{learner}_metric.json`` per learner.  ``train`` and ``evaluate`` take
``--mesh SPEC`` (axes ``data`` and ``model``, e.g. ``data=2`` or
``data=2,model=2``): the command becomes rank 0 of a world of one process
per card (``parallel/launch.py`` starts the others, their output in
``<run dir>/rank-<r>.log``; under ``torchrun`` the existing world is
used), and rank 0 alone writes the outputs and prints the JSON line.  A
spec that needs more cards than are visible, or names another axis, exits
2.  ``train`` on a ``model`` axis trains replicated copies of the params,
as the JAX trainers do.  ``serve --mesh SPEC`` runs ONE service across the
world: rank 0, the leader, serves HTTP and runs the whole service, and
sends each device call to ranks 1..n−1, the followers, which score their
``data`` slice of each block against their ``model`` shard of the bank
(``serving/mesh.py``; their logs in ``-o``'s dir, else a temporary one);
it takes the bucketed strategy and one replica (``--replicas`` with a
mesh exits 2: pick one scaling axis), SIGTERM drains rank 0 and then stops
the followers, and a follower that dies ends the world (exit 1).
``evaluate``, and ``serve`` of an archive that runs one replica, take a
``data`` mesh over every visible card when there are several, unless
``--no-mesh``; ``serve --hosts`` validates a ``--mesh`` spec and ignores
it (the balancer scores nothing).
``bench`` runs the benchmark harness (``bench.py``, its env knobs) in a
supervised child and prints its one JSON record; ``tune`` is the offline
autotuner (exit 0 tuned, 1 no winner, 2 the ``unknown_device_class``
refusal; ``--report`` renders the roofline table); ``doctor`` diagnoses
the environment and a config's artifacts (exit 1 on a failed check).
``parity`` runs the real-weights F1-parity chain (``evaluate/parity.py``:
convert parity against HF's ``BertModel``, skipped with ``ok`` false where
``transformers`` is missing; a reference archive scored on the device; the
metric diff; exit 0 ok, 1 not ok, 2 usage or missing inputs).  ``lint``
runs the static-analysis engine over the port's sources (exit 0 clean, 1
findings, 2 usage; ``--json`` the machine-readable document).
The commands that compute on a device (``pretrain``, ``train``,
``evaluate``, ``score-corpus``, ``serve``, ``bank shadow``, ``bank
promote``, ``selfcheck``, ``baseline``, ``tune``, ``doctor``, ``parity``) run on the
card (``--device cuda``, the default) unless ``--device cpu`` is given;
``bench`` takes ``BENCH_DEVICE=cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading


def _profiled(args, primary: bool = True):
    """``--profile DIR``: a profiler trace of the whole command
    (``DIR/trace.json``; a mesh's rank 0 only); without it, nothing."""
    from .utils.profiling import trace_context

    return trace_context(getattr(args, "profile", None) if primary else None)


def cmd_pretrain(args) -> int:
    from .build import pretrain_from_config
    from .config import load_config
    from .pretrain.mlm import read_corpus_lines

    config = load_config(args.config, overrides=args.overrides)
    val_path = config.get("validation_data_path")
    if val_path:
        # fail fast on a missing or empty eval corpus, not after training
        try:
            read_corpus_lines(val_path)
        except (OSError, ValueError) as e:
            print(f"validation_data_path unusable: {e}", file=sys.stderr)
            return 2
    with _profiled(args):
        report = pretrain_from_config(config, device=args.device, export_hf=args.export_hf)
    report.pop("train")
    print(json.dumps(report))
    return 0


class MeshSpecError(ValueError):
    """A ``--mesh`` spec the host cannot run: a usage error (exit 2)."""


def _parse_mesh(spec):
    """``"data=8"`` or ``"data=4,model=2"`` → the axes dict; a malformed
    spec is a :class:`MeshSpecError` with the JAX package's usage message."""
    allowed = {"data", "model"}  # the axes shard_batch and the bank act on
    axes = {}
    try:
        for part in spec.split(","):
            name, size = part.split("=")
            name = name.strip()
            if name not in allowed:
                raise ValueError(f"unknown axis {name!r}")
            axes[name] = int(size)
            if axes[name] < 1:
                raise ValueError(f"axis {name!r} needs a size >= 1")
    except ValueError as e:
        raise MeshSpecError(
            f'--mesh {spec!r}: {e} (expected e.g. "data=8" or "data=4,model=2"; axes from '
            f"{sorted(allowed)}; sizes must multiply to the device count)") from None
    return axes


def auto_mesh_spec(cards: int, no_mesh: bool, replicas: int = 1,
                   autoscale: bool = False) -> "str | None":
    """The automatic mesh (the JAX package's over its devices): a ``data``
    axis over every visible card when there are several, unless
    ``--no-mesh`` or the service scales by replicas instead; else None."""
    if no_mesh or cards <= 1 or replicas > 1 or autoscale:
        return None
    return f"data={cards}"


def _mesh_spec(args, command: str):
    """``--mesh``; for ``evaluate`` also the automatic data mesh over
    several visible cards."""
    if args.mesh is not None or command != "evaluate" or args.device != "cuda":
        return args.mesh
    import torch

    return auto_mesh_spec(torch.cuda.device_count(), args.no_mesh)


def _mesh_axes(spec: str, device: str):
    """(axes, rank count) of a spec the host can run: on the card, no more
    ranks than visible cards (a :class:`MeshSpecError` otherwise)."""
    import numpy as np

    axes = _parse_mesh(spec)
    n = int(np.prod(list(axes.values())))
    if device == "cuda":
        import torch

        visible = torch.cuda.device_count()
        if n > visible:
            raise MeshSpecError(f"--mesh {spec!r}: mesh axes {axes} need {n} devices, "
                                f"have {visible}")
    return axes, n


def _open_mesh(args, run_dir, spec):
    """``spec`` → (this rank's mesh, the launched world or None); (None,
    None) without one.  Rank 0 of a new world starts the other ranks
    here."""
    if spec is None:
        return None, None
    from .parallel import create_mesh
    from .parallel import launch

    axes, n = _mesh_axes(spec, args.device)
    world = None
    if launch.is_launched_child():
        launch.watch_parent()
    elif n > 1 and not launch.in_world():
        world = launch.spawn(args.argv, n, run_dir)
    try:
        return create_mesh(axes, device=args.device), world
    except BaseException:
        if world is not None:
            world.close(ok=False)
        raise


def _run_on_mesh(args, run_dir, command: str, run):
    """``run(mesh)`` on this rank, the world closed after it: a failure
    anywhere ends every rank, and rank 0 exits 0 only when each rank
    did.  Returns (result, exit code, primary)."""
    mesh, world = _open_mesh(args, run_dir, _mesh_spec(args, command))
    primary = mesh is None or mesh.is_primary
    ok = False
    try:
        with _profiled(args, primary):
            result = run(mesh)
        ok = True
    finally:
        rc = world.close(ok) if world is not None else 0
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return result, rc, primary


def cmd_train(args) -> int:
    from .build import train_from_config
    from .config import load_config

    config = load_config(args.config, overrides=args.overrides)
    result, rc, primary = _run_on_mesh(
        args, args.serialization_dir, "train",
        lambda mesh: train_from_config(config, args.serialization_dir, device=args.device,
                                       mesh=mesh))
    if primary:
        print(json.dumps({k: result.get(k) for k in ("best_epoch", "best_validation", "archive")}))
    return rc


def cmd_evaluate(args) -> int:
    from .build import evaluate_from_archive

    metrics, rc, primary = _run_on_mesh(
        args, args.out_dir, "evaluate",
        lambda mesh: evaluate_from_archive(
            args.archive, args.test_path, args.out_dir,
            overrides=args.overrides, golden_file=args.golden_file, name=args.name,
            thres=args.threshold, device=args.device, mesh=mesh, use_mesh=not args.no_mesh,
        ))
    if primary:
        print(json.dumps(metrics, default=float))
    return rc


def cmd_telemetry_report(args) -> int:
    """A run dir's sinks as the text report, or with ``--json`` the
    machine-readable one (exit 2: not a directory)."""
    from pathlib import Path

    from .telemetry.report import render_report, report_json

    run_dir = Path(args.run_dir)
    if not run_dir.is_dir():
        print(f"telemetry-report: {run_dir} is not a directory", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report_json(run_dir), indent=2, default=str))
    else:
        print(render_report(run_dir))
    return 0


def cmd_baseline(args) -> int:
    from .baselines import run_baselines

    metrics = run_baselines(
        args.train_path, args.test_path, args.out_dir,
        feature_selection=not args.no_feature_selection, device=args.device,
    )
    print(json.dumps(metrics, default=float))
    return 0


def _serve_mesh_spec(args):
    """``serve``'s mesh: ``--mesh``, else the automatic data mesh over
    several visible cards when the archive (with ``--overrides``) serves
    one replica without an autoscaler; none for ``--hosts``, which loads
    no archive.  What a mesh refuses (another scaling axis, the packed and
    cascaded strategies) is refused here, before any rank starts."""
    if args.hosts or not args.archive:
        return None
    spec = args.mesh
    cards = 0
    if spec is None:
        if args.no_mesh or args.device != "cuda":
            return None
        import torch

        cards = torch.cuda.device_count()
        if cards <= 1:
            return None
    else:
        _mesh_axes(spec, args.device)
    scaling = MeshSpecError("--mesh shards ONE service across devices; replicas > 1 runs "
                            "one service PER device — pick one scaling axis")
    if spec is not None and (args.replicas or 1) > 1:
        raise scaling
    from .archive import load_archive_config
    from .config import serving_config
    from .evaluate.predict_memory import refuse_mesh_score_impl

    serve_cfg = serving_config(load_archive_config(args.archive, args.overrides)[0])
    replicas = int(serve_cfg["replicas"] if args.replicas is None else args.replicas)
    autoscale = bool(serve_cfg["autoscale_enabled"])
    if spec is None:
        return auto_mesh_spec(cards, args.no_mesh, replicas, autoscale)
    if replicas > 1 or autoscale:
        raise scaling
    refuse_mesh_score_impl(str(serve_cfg["score_impl"]), spec)
    return spec


def _serve_target(args, mesh=None):
    """The serve command's target: without an archive, a
    :class:`HostBalancer` over running serve processes (``--hosts``, else
    the overrides' ``serving.hosts``, else ``MEMVUL_FLEET_HOSTS``; a
    ``--mesh`` spec is validated and ignored), else
    ``build.serve_from_archive`` (on ``mesh``: rank 0's service, or a
    follower's handle on another rank).  Returns (target, None) or (None,
    exit code) after printing the usage error."""
    if args.archive and args.hosts:
        print("serve: --hosts balances running serve processes and loads no archive",
              file=sys.stderr)
        return None, 2
    if not args.archive:
        from .build import serve_from_hosts

        if args.mesh is not None:
            _parse_mesh(args.mesh)  # a malformed spec is a usage error
        try:
            return serve_from_hosts(
                args.hosts, out_dir=args.out_dir, overrides=args.overrides,
                tsdb_cadence=args.tsdb_cadence, default_port=args.port or 8341,
            ), None
        except ValueError as e:
            print(f"serve: an archive is required, or {e}", file=sys.stderr)
            return None, 2
    from .build import serve_from_archive

    return serve_from_archive(
        args.archive, out_dir=args.out_dir, overrides=args.overrides,
        golden_file=args.golden_file, device=args.device, replicas=args.replicas,
        tenants=args.tenants, tsdb_cadence=args.tsdb_cadence, mesh=mesh,
        use_mesh=not args.no_mesh,
    ), None


def cmd_serve(args) -> int:
    """Serve over HTTP until SIGTERM/SIGINT; on a mesh rank 0 serves and
    every other rank follows it, exiting 0 after rank 0's drain stops it."""
    import tempfile

    try:
        spec = _serve_mesh_spec(args)
        log_dir = args.out_dir or (tempfile.mkdtemp(prefix="memvul_serve_mesh_") if spec else None)
        mesh, world = _open_mesh(args, log_dir, spec)
    except (MeshSpecError, OSError, ValueError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    from .serving.mesh import MeshFollower

    rc, ok = 1, False
    try:
        try:
            service, rc = _serve_target(args, mesh)
        except (ValueError, NotImplementedError) as e:
            print(f"serve: {e}", file=sys.stderr)
            service, rc = None, 2
        if isinstance(service, MeshFollower):
            service.run()
            rc = 0
        elif service is not None:
            rc = _serve_http(args, service, world)
        ok = rc == 0
    finally:
        if world is not None:
            world_rc = world.close(ok)
            if ok:  # rank 0 exits 0 only when every rank did
                rc = world_rc
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return rc


def _serve_http(args, service, world) -> int:
    """The HTTP front end over ``service`` until SIGTERM/SIGINT, then its
    drain; 1 when a serving mesh's channel failed."""
    from . import telemetry
    from .serving.frontend import run_http_server

    # the run dir doubles as the POST /profilez capture root
    server = run_http_server(service, host=args.host, port=args.port, profile_dir=args.out_dir)
    stop = threading.Event()

    def _stop_handler(signum, frame):
        service.request_drain()
        stop.set()

    previous = [(sig, signal.signal(sig, _stop_handler)) for sig in (signal.SIGTERM, signal.SIGINT)]
    host, port = server.server_address[:2]
    predictor = getattr(service, "predictor", None)
    mesh = getattr(predictor, "mesh", None)
    channel = getattr(predictor, "channel", None)
    line = {"serving": f"http://{host}:{port}", "pid": os.getpid(),
            "replicas": len(getattr(service, "replicas", ())) or 1,
            "hosts": len(getattr(service, "hosts", ())) or None}
    if mesh is not None:
        line["mesh"] = dict(mesh.shape)
        line["rank_pids"] = [os.getpid()] + ([p.pid for p in world.procs] if world else [])
    print(json.dumps(line), flush=True)
    rc = 0
    try:
        while not stop.is_set():
            stop.wait(0.5)
            if channel is not None and channel.failed is not None:
                print(f"serve: the mesh failed: {channel.failed}", file=sys.stderr)
                rc = 1
                break
    finally:
        server.shutdown()
        service.drain()  # stops the attached monitors, and a mesh's followers
        for sig, handler in previous:
            signal.signal(sig, handler)
        telemetry.get_registry().close()
    return rc


def cmd_score_corpus(args) -> int:
    """Sharded corpus scoring: exit 0 done, 1 the merge verification
    failed, 2 a usage error, 3 partial completion (the machine-readable
    refusal as JSON on stdout)."""
    from .distributed import MergeVerificationError, PartialCompletionError, score_corpus

    try:
        result = score_corpus(
            args.archive, args.test_path, args.out_dir, shards=args.shards,
            overrides=args.overrides, golden_file=args.golden_file, name=args.name,
            thres=args.threshold, split=args.split, device=args.device,
        )
    except PartialCompletionError as e:
        print(json.dumps(e.payload, default=str))
        return 3
    except MergeVerificationError as e:
        print(json.dumps(e.payload, default=str), file=sys.stderr)
        return 1
    except (ValueError, NotImplementedError) as e:
        print(f"score-corpus: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result, default=float))
    return 0


# -- the anchor-bank lifecycle --------------------------------------------------


def _bank_store(args):
    """The subcommand's bank store; ``--tenant NAME`` scopes it to
    ``<store>/<NAME>``, the per-tenant layout ``serve --tenants`` points
    at."""
    from pathlib import Path

    from .bankops import BankStore
    from .serving.tenancy import validate_tenant_name

    tenant = getattr(args, "tenant", None)
    if not tenant:
        return BankStore(args.store)
    return BankStore(Path(args.store) / validate_tenant_name(tenant))


def _bank_predictor(args):
    """A serving-shaped predictor over an archive on ``--device`` (the
    ``serving`` section's batch, length cap and buckets): what ``shadow``
    and ``promote`` score banks through.  Returns (predictor, reader,
    the archive's ``bankops`` section)."""
    from .archive import load_archive
    from .build import build_reader
    from .config import bankops_config, serving_config
    from .evaluate.predict_memory import SiamesePredictor

    arch = load_archive(args.archive, overrides=args.overrides, device=args.device)
    serve_cfg = serving_config(arch.config)
    max_length = min(int(serve_cfg["max_length"]), arch.model.config.max_position_embeddings)
    buckets = serve_cfg["buckets"]
    predictor = SiamesePredictor(
        arch.model, arch.tokenizer, batch_size=int(serve_cfg["max_batch"]),
        max_length=max_length, buckets=[int(b) for b in buckets] if buckets else None,
    )
    return predictor, build_reader(arch.config.get("dataset_reader")), bankops_config(arch.config)


def cmd_bank_build(args) -> int:
    """Commit an anchor JSON (``build-data``'s output) as a root version."""
    from .data.cwe import load_anchors

    manifest = _bank_store(args).create(load_anchors(args.anchors), source=args.source,
                                        note=args.note)
    print(json.dumps(manifest, indent=2))
    return 0


def cmd_bank_diff(args) -> int:
    """Derive a version from a parent through add/retire/reweight/edit ops
    (``--ops`` JSON, inline or a file, and the repeatable conveniences)."""
    from pathlib import Path

    from .bankops import BankDiff

    store = _bank_store(args)
    ops = []
    if args.ops:
        raw = Path(args.ops).read_text() if Path(args.ops).exists() else args.ops
        ops.extend(json.loads(raw))
    ops.extend({"op": "retire", "category": cat} for cat in args.retire or [])
    for spec in args.reweight or []:
        cat, _, weight = spec.partition("=")
        ops.append({"op": "reweight", "category": cat, "weight": float(weight)})
    parent = args.parent or store.latest()
    if parent is None:
        print("bank diff: empty store — run `bank build` first", file=sys.stderr)
        return 2
    print(json.dumps(store.derive(parent, BankDiff.from_json(ops), note=args.note), indent=2))
    return 0


def cmd_bank_log(args) -> int:
    """The lineage of a version (default: the latest), root first, and the
    ACTIVE pointer."""
    store = _bank_store(args)
    print(json.dumps({"versions": store.versions(), "active": store.active(),
                      "lineage": store.log(args.version)}, indent=2))
    return 0


def cmd_bank_shadow(args) -> int:
    """Offline shadow: replay a recorded ``predict_file`` output against a
    candidate version; writes ``shadow_deltas.jsonl`` and
    ``shadow_summary.json`` and prints the summary."""
    from pathlib import Path

    from .bankops import replay_results
    from .resilience.io import atomic_write_text

    store = _bank_store(args)
    predictor, reader, bank_cfg = _bank_predictor(args)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary = replay_results(
        predictor, store.instances(args.candidate), reader, corpus_path=args.corpus,
        results_path=args.results, out_dir=out_dir, split=args.split,
        threshold=float(bank_cfg["shadow_threshold"] if args.threshold is None
                        else args.threshold),
        candidate_version=args.candidate,
    )
    atomic_write_text(out_dir / "shadow_summary.json", json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return 0


def cmd_bank_promote(args) -> int:
    """The promotion gate for a candidate: golden-set AUC/F1 parity against
    the active version and the shadow summary's thresholds.  Prints the
    machine-readable decision; ``--apply`` also advances the store's ACTIVE
    pointer (a live service promotes in-process through
    ``bankops.promote``).  Exit 0 approved, 1 refused, 2 usage.  A
    threshold flag left out takes the archive's ``bankops`` value."""
    from pathlib import Path

    from .bankops import GateThresholds, evaluate_candidate

    store = _bank_store(args)
    predictor, reader, bank_cfg = _bank_predictor(args)
    shadow_summary = (json.loads(Path(args.shadow_summary).read_text())
                      if args.shadow_summary else None)

    def pick(flag, key):
        return bank_cfg[key] if flag is None else flag

    thresholds = GateThresholds(
        max_auc_drop=float(pick(args.max_auc_drop, "max_auc_drop")),
        max_f1_drop=float(pick(args.max_f1_drop, "max_f1_drop")),
        max_flip_rate=float(pick(args.max_flip_rate, "max_flip_rate")),
        min_shadow_samples=int(pick(args.min_shadow_samples, "min_shadow_samples")),
        require_shadow=not args.no_shadow,
    )
    decision = evaluate_candidate(
        predictor, store, args.candidate, reader.read(str(args.golden_set), split=args.split),
        active=args.active, shadow_summary=shadow_summary, thresholds=thresholds,
    )
    store.record_promotion(kind="gate_decision", tenant=args.tenant, **decision.to_json())
    if decision.approved and args.apply:
        store.set_active(args.candidate, source="promotion")
    print(json.dumps(decision.to_json(), indent=2))
    return 0 if decision.approved else 1


# -- the offline pipeline -------------------------------------------------------


def cmd_build_data(args) -> int:
    """CSV corpus → cleaned project splits, CWE anchors and the MLM corpus."""
    import csv
    from pathlib import Path

    from .data.corpus import preprocess, split_by_project, write_json, write_mlm_corpus
    from .data.cwe import (
        build_anchors, build_cwe_tree, build_full_view_anchors, cwe_distribution,
        load_research_view_csv, save_anchors,
    )

    if args.full_view_anchors and not args.cwe_csv:
        print("--full-view-anchors requires --cwe-csv", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(args.csv, newline="", encoding="utf-8") as f:
        reports = list(csv.DictReader(f))
    cve_dict = json.loads(Path(args.cve_dict).read_text()) if args.cve_dict else {}
    clean = preprocess(reports)
    train, test = split_by_project(clean, held_out_frac=0.1, seed=args.seed)
    train, validation = split_by_project(train, held_out_frac=0.1, seed=args.seed + 1)
    write_json(train, out / "train_project.json")
    write_json(validation, out / "validation_project.json")
    write_json(test, out / "test_project.json")
    n_lines = write_mlm_corpus(clean, out / "train_project_mlm.txt")
    n_anchors = n_full = 0
    tree = build_cwe_tree(load_research_view_csv(args.cwe_csv)) if args.cwe_csv else None
    dist = None
    if tree is not None and cve_dict:
        positives = [r for r in train if str(r.get("Security_Issue_Full")) in ("1", "1.0")]
        for r in positives:
            cve = cve_dict.get(r.get("CVE_ID"))
            if cve:
                r.setdefault("CWE_ID", cve.get("CWE_ID"))
        dist = cwe_distribution(positives, cve_dict)
        anchors = build_anchors(dist, tree, cve_dict, seed=args.seed)
        save_anchors(anchors, out / "CWE_anchor_golden_project.json")
        n_anchors = len(anchors)
    if args.full_view_anchors:
        full = build_full_view_anchors(tree, cve_dict, dist, seed=args.seed)
        save_anchors(full, out / "CWE_anchor_full_view.json")
        n_full = len(full)
    print(json.dumps({"train": len(train), "validation": len(validation), "test": len(test),
                      "mlm_lines": n_lines, "anchors": n_anchors, "full_view_anchors": n_full}))
    return 0


def cmd_analyze(args) -> int:
    """The paper's analyses over a corpus JSON: keyword study, report→CVE
    disclosure-lag histogram, CWE-category ECDF, attack-step counts, repo
    statistics."""
    from pathlib import Path

    from .data.analysis import (
        count_attack_steps, cumulative_cwe_distribution, cwe_report_distribution,
        delta_days_histogram, join_positives_with_cve, keyword_match_study, repo_stats,
    )

    samples = json.loads(Path(args.corpus).read_text())
    cve_dict = json.loads(Path(args.cve_dict).read_text()) if args.cve_dict else {}
    report: dict = {"num_samples": len(samples)}
    report["keyword_match"] = keyword_match_study(samples)
    positives = join_positives_with_cve(samples, cve_dict)
    report["attack_steps"] = count_attack_steps(positives)
    # Published_Date rides on the records when present; the CVE dict is a fallback
    report["delta_days"] = delta_days_histogram(positives, cve_dict or None)
    if cve_dict:
        report["cwe_cumulative"] = cumulative_cwe_distribution(cwe_report_distribution(positives))
    if args.repo_info:
        report["repo_stats"] = repo_stats(samples, json.loads(Path(args.repo_info).read_text()))
    text = json.dumps(report, indent=2, default=float)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


def cmd_selfcheck(args) -> int:
    """One-command acceptance run on ``--device``: a synthetic workspace, a
    tiny memory-model train, the archive, ``evaluate`` with the threshold
    its validation swept, and the metric contract."""
    import tempfile
    from pathlib import Path

    from .build import evaluate_from_archive, resolve_device, train_from_config
    from .data.synthetic import build_workspace, selfcheck_config

    device = resolve_device(args.device)
    workdir = Path(args.dir) if args.dir else Path(tempfile.mkdtemp(prefix="memvul_selfcheck_"))
    print(f"selfcheck workspace: {workdir}", file=sys.stderr)
    # 8 projects keep every project-level split non-empty
    ws = build_workspace(workdir / "data", seed=args.seed, num_projects=args.projects,
                         reports_per_project=args.reports)
    splits = {name: len(json.loads(Path(ws["paths"][name]).read_text()))
              for name in ("train", "validation", "test")}
    result = train_from_config(selfcheck_config(ws), workdir / "out", device=device)
    archive = result.get("archive")
    # the threshold the validation sweep chose, as the reference applies it
    # at test; an empty validation set reports 0.0, which keeps 0.5
    thres = 0.5
    for em in result.get("history", []):
        if em.get("epoch") == result.get("best_epoch") and "validation_s_thres" in em:
            swept = float(em["validation_s_thres"])
            if swept > 0.0:
                thres = swept
    metrics = evaluate_from_archive(str(workdir / "out"), ws["paths"]["test"],
                                    str(workdir / "eval"), name="selfcheck", thres=thres,
                                    device=device)
    required = ("TP", "FN", "TN", "FP", "prec", "f1", "auc")
    missing = [k for k in required if k not in metrics]
    ok = bool(archive) and not missing and all(splits.values())
    print(json.dumps({"selfcheck": "ok" if ok else "fail", "device": device.type,
                      "archive": archive, "splits": splits, "missing_metric_keys": missing,
                      "metrics": {k: metrics.get(k) for k in required}}, default=float))
    return 0 if ok else 1


def cmd_bench(args) -> int:
    """The benchmark harness (``bench.py``): its env knobs, one JSON
    record (``BENCH_LINT=1`` prints the lint record before it), exit 0
    measured / 1 failed."""
    from .bench import main as bench_main

    return int(bench_main() or 0)


def cmd_tune(args) -> int:
    """The offline autotuner (``tuning/``): sweep the knob space for this
    device class, prune analytically, microbench the survivors behind the
    parity gate, and persist the versioned tuned profile.  ``--report``
    renders the roofline markdown instead.  Exit 0 tuned (the record on
    stdout), 1 no usable winner, 2 a usage error or the machine-readable
    ``unknown_device_class`` refusal."""
    from pathlib import Path

    if args.report is not None:
        from .tuning.report import report_from_programs_json, splice_generated_section

        path = Path(args.report)
        if path.is_dir():
            path = path / "programs.json"
        if not path.is_file():
            print(f"tune --report: {path} not found (pass a run dir that wrote "
                  "programs.json, or the file itself)", file=sys.stderr)
            return 2
        md = report_from_programs_json(path)
        if args.splice:
            doc = Path(args.splice)
            if not doc.is_file():
                print(f"tune --splice: {doc} not found", file=sys.stderr)
                return 2
            doc.write_text(splice_generated_section(doc.read_text(), md))
            print(f"tune: generated section spliced into {doc}", file=sys.stderr)
        print(md)
        return 0

    from .tuning.autotune import run_tune

    bench_kwargs = dict(
        seed=args.seed, model_size=args.model, seq_len=args.seq_len,
        batch_size=args.batch_size, steps_per_epoch=args.steps,
        n_requests=args.requests, n_clients=args.clients, max_batch=args.max_batch,
    )
    # the full grids are a long sweep; the default is the slim grid (the
    # same axes, fewer points)
    train_space_kwargs = None if args.full_space else dict(
        bucket_grids=[None, "pow2"], dedup_options=(True,), prefetch_depths=(2, 8),
    )
    serve_space_kwargs = None if args.full_space else dict(
        wait_ms_options=(2.0, 5.0), budget_factors=(2, 4), rows_factors=(1,),
    )
    record = run_tune(
        args.mode,
        device_class=args.device_class,
        allow_unknown_device=args.allow_unknown_device,
        out_dir=args.out,
        cascade=args.cascade,
        target_rescore_rate=args.target_rescore_rate,
        max_programs=args.max_programs,
        hbm_fraction=args.hbm_fraction,
        bench_kwargs=bench_kwargs,
        train_space_kwargs=train_space_kwargs,
        serve_space_kwargs=serve_space_kwargs,
        device=args.device,
    )
    print(json.dumps(record, indent=2, default=float))
    if record.get("error") == "unknown_device_class":
        return 2
    # no parity-passing winner anywhere leaves the defaults: a failed run
    return 0 if record.get("profile") else 1


def cmd_doctor(args) -> int:
    """Environment and artifact self-diagnosis (``utils/doctor.py``): one
    JSON report, exit 1 on any failed check."""
    from .utils.doctor import run_doctor

    report = run_doctor(config=args.config, device_timeout_s=args.device_timeout,
                        skip_device=args.skip_device, device=args.device)
    print(json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 1


def cmd_parity(args) -> int:
    """The real-weights F1-parity chain (``evaluate/parity.py``) on
    ``--device``: convert parity at the checkpoint's geometry, reference
    archive scoring, the metric diff against the reference pipeline's own
    file.  Exit 0 ok, 1 not ok, 2 usage or missing inputs."""
    from .evaluate.parity import run_parity

    try:
        report = run_parity(
            args.hf_dir, archive=args.archive, corpus=args.corpus, anchors=args.anchors,
            ref_metrics=args.ref_metrics, out_dir=args.out_dir, max_length=args.max_length,
            batch_size=args.batch_size, thres=args.threshold, atol=args.atol,
            seq_len=args.seq_len, device=args.device,
        )
    except (ValueError, FileNotFoundError) as e:
        # usage or missing-artifact problems exit 2, apart from exit 1:
        # parity ran and failed its tolerance
        print(f"parity: {e}", file=sys.stderr)
        return 2
    print(json.dumps(report, indent=2, default=float))
    return 0 if report["ok"] else 1


def cmd_lint(args) -> int:
    """The static-analysis engine (``analysis/``) over the port's own
    sources: one AST parse per file shared by every checker (bare print,
    handler and router blocking, artifact writes, forward purity, lock
    discipline, the fault/metric/config/kernel-build drift checks).  Exit 0
    clean, 1 findings, 2 usage."""
    from .analysis.cli import run_lint

    return run_lint(args)


def _add_bank_parsers(sub) -> None:
    bank = sub.add_parser("bank", help="anchor-bank lifecycle: versioned store (build/diff/log), "
                          "offline shadow scoring of a candidate, the promotion gate")
    bank_sub = bank.add_subparsers(dest="bank_command", required=True)
    tenant_help = "scope the store to <store>/<tenant>, the layout serve --tenants points at"
    b = bank_sub.add_parser("build", help="commit an anchor JSON as a root store version")
    b.add_argument("--store", required=True, help="bank store root dir")
    b.add_argument("--anchors", required=True,
                   help="anchor JSON (e.g. CWE_anchor_golden_project.json)")
    b.add_argument("--source", default="build", help="provenance tag")
    b.add_argument("--note", default=None)
    b.add_argument("--tenant", default=None, metavar="NAME", help=tenant_help)
    b.set_defaults(fn=cmd_bank_build)
    b = bank_sub.add_parser("diff", help="derive a new version via add/retire/reweight/edit ops")
    b.add_argument("--store", required=True)
    b.add_argument("--parent", default=None, help="parent version id (default: latest)")
    b.add_argument("--ops", default=None, help="JSON list of diff ops (inline or a file path)")
    b.add_argument("--retire", action="append", metavar="CATEGORY",
                   help="retire one category (repeatable)")
    b.add_argument("--reweight", action="append", metavar="CATEGORY=W",
                   help="reweight one category (repeatable)")
    b.add_argument("--note", default=None)
    b.add_argument("--tenant", default=None, metavar="NAME", help=tenant_help)
    b.set_defaults(fn=cmd_bank_diff)
    b = bank_sub.add_parser("log", help="lineage of a version (root first) and the ACTIVE pointer")
    b.add_argument("--store", required=True)
    b.add_argument("version", nargs="?", default=None)
    b.add_argument("--tenant", default=None, metavar="NAME", help=tenant_help)
    b.set_defaults(fn=cmd_bank_log)
    b = bank_sub.add_parser("shadow", help="offline shadow: replay a recorded predict_file output "
                            "against a candidate version")
    b.add_argument("--store", required=True)
    b.add_argument("--candidate", required=True, help="store version id")
    b.add_argument("--archive", required=True, help="model.tar.gz or its serialization dir")
    b.add_argument("--corpus", required=True, help="the corpus file the recorded run scored")
    b.add_argument("--results", required=True, help="the recorded run's <name>_result.json")
    b.add_argument("-o", "--out-dir", required=True)
    b.add_argument("--split", default=None)
    b.add_argument("--threshold", type=float, default=None,
                   help="decision threshold (default: the archive's bankops.shadow_threshold)")
    b.add_argument("--overrides", default=None)
    b.add_argument("--tenant", default=None, metavar="NAME", help=tenant_help)
    b.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    b.set_defaults(fn=cmd_bank_shadow)
    b = bank_sub.add_parser("promote", help="the promotion gate: golden-set AUC/F1 parity and "
                            "shadow flip-rate thresholds (exit 0 approved / 1 refused)")
    b.add_argument("--store", required=True)
    b.add_argument("--candidate", required=True, help="store version id")
    b.add_argument("--archive", required=True)
    b.add_argument("--golden-set", required=True,
                   help="pinned labeled eval corpus for the parity check")
    b.add_argument("--active", default=None, help="store version to gate against (default: the "
                   "ACTIVE pointer, else the candidate's parent)")
    b.add_argument("--shadow-summary", default=None,
                   help="shadow summary JSON (bank shadow / ShadowScorer)")
    b.add_argument("--no-shadow", action="store_true", help="gate on golden-set parity alone")
    b.add_argument("--apply", action="store_true",
                   help="advance the store ACTIVE pointer on approval")
    b.add_argument("--split", default=None)
    b.add_argument("--max-auc-drop", type=float, default=None)
    b.add_argument("--max-f1-drop", type=float, default=None)
    b.add_argument("--max-flip-rate", type=float, default=None)
    b.add_argument("--min-shadow-samples", type=int, default=None)
    b.add_argument("--overrides", default=None)
    b.add_argument("--tenant", default=None, metavar="NAME", help=tenant_help)
    b.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    b.set_defaults(fn=cmd_bank_promote)


def _add_mesh_flags(p, serve: bool = False) -> None:
    """The reference's ``--mesh SPEC`` and ``--no-mesh``."""
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help='ONE service across a device mesh, one process per card: "data=2" or '
                   '"data=2,model=2"; rank 0 serves, the others score their data slice against '
                   "their model shard of the bank (bucketed only; with --hosts: validated, "
                   "then ignored)" if serve else
                   'a device mesh, one process per card: "data=2" or "data=2,model=2" '
                   "(the model axis shards the scorer's anchor bank; in training it holds "
                   "replicated copies)")
    p.add_argument("--no-mesh", action="store_true",
                   help="run on one device (evaluate, serve: no automatic data mesh over "
                   "several cards)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m memvul_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    pt = sub.add_parser("pretrain", help="MLM further pretraining of the encoder")
    pt.add_argument("config", help="pretrain config (configs/further_pretrain.json)")
    pt.add_argument("-o", "--overrides", default=None,
                    help="JSON (Jsonnet subset) config overrides")
    pt.add_argument("--export-hf", action="store_true",
                    help="also write an HF checkpoint dir (<output_dir>/hf) that the "
                    "reference's AutoModel.from_pretrained consumes")
    pt.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pt.add_argument("--profile", default=None, metavar="DIR",
                    help="a profiler trace of the whole run (DIR/trace.json)")
    pt.set_defaults(fn=cmd_pretrain)
    tr = sub.add_parser("train", help="train the model a config describes")
    tr.add_argument("config", help="training config (JSON / Jsonnet subset)")
    tr.add_argument("-s", "--serialization-dir", required=True)
    tr.add_argument("-o", "--overrides", default=None,
                    help="JSON (Jsonnet subset) config overrides")
    tr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    tr.add_argument("--profile", default=None, metavar="DIR",
                    help="a profiler trace of the whole run (DIR/trace.json)")
    _add_mesh_flags(tr)
    tr.set_defaults(fn=cmd_train)
    ev = sub.add_parser("evaluate", help="score a corpus with an archived model")
    ev.add_argument("archive", help="model.tar.gz or a serialization dir holding one")
    ev.add_argument("test_path", help="corpus file (.json array or .jsonl)")
    ev.add_argument("-o", "--out-dir", required=True)
    ev.add_argument("--overrides", default=None, help="JSON (Jsonnet subset) config overrides")
    ev.add_argument("--golden-file", "--golden", dest="golden_file", default=None,
                    help="anchor file (default: the config's anchor_path)")
    ev.add_argument("--name", default=None, help="output file prefix (default: the model type)")
    ev.add_argument("--threshold", "--thres", dest="threshold", type=float, default=0.5)
    ev.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ev.add_argument("--profile", default=None, metavar="DIR",
                    help="a profiler trace of the whole evaluation (DIR/trace.json)")
    _add_mesh_flags(ev)
    ev.set_defaults(fn=cmd_evaluate)
    sv = sub.add_parser("serve", help="online scoring service over HTTP; --hosts balances "
                        "over running serve processes")
    sv.add_argument("archive", nargs="?", default=None,
                    help="model.tar.gz or a serialization dir holding one (not with --hosts)")
    sv.add_argument("--hosts", default=None,
                    help="comma-separated host[:port] or URLs of running serve processes to "
                    "balance across (else serving.hosts of --overrides, else "
                    "MEMVUL_FLEET_HOSTS; the fleet_* keys set supervision); merges /healthz, /metrics, "
                    "/tracez, /programz and routes around dead or stalled hosts")
    sv.add_argument("-o", "--out-dir", default=None,
                    help="run dir: telemetry.json at drain, incident bundles, and the "
                    "POST /profilez capture root")
    sv.add_argument("--tsdb-cadence", type=float, default=None, metavar="SECONDS",
                    help="metrics-history cadence: GET /metricsz, the alert rules (GET "
                    "/alertz) and, with -o, incident bundles (default: the config's "
                    "telemetry.tsdb_cadence_s; 0 = off)")
    sv.add_argument("--overrides", default=None, help="JSON (Jsonnet subset) config overrides")
    sv.add_argument("--golden-file", default=None, help="anchor file (default: the config's anchor_path)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8341, help="0 binds an ephemeral port")
    sv.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sv.add_argument("--replicas", type=int, default=None,
                    help="scoring services behind a load-balancing router, on "
                    "cuda:{i %% cards} (default: the config's serving.replicas)")
    sv.add_argument("--tenants", default=None, metavar="SPEC",
                    help="named tenants, 'name=store_dir,...': each tenant's active bank "
                    "from its store; requests carry a 'tenant' field or an X-MemVul-Tenant "
                    "header (default: the config's serving.tenants)")
    _add_mesh_flags(sv, serve=True)
    sv.set_defaults(fn=cmd_serve)
    sc = sub.add_parser("score-corpus", help="sharded corpus scoring: supervised worker "
                        "subprocesses, exactly-once merge (exit 3: partial)")
    sc.add_argument("archive", help="model.tar.gz or a serialization dir holding one")
    sc.add_argument("test_path")
    sc.add_argument("-o", "--out-dir", required=True)
    sc.add_argument("--shards", type=int, default=None,
                    help="worker subprocesses (default: the evaluation section's shards)")
    sc.add_argument("--overrides", default=None, help="JSON (Jsonnet subset) config overrides")
    sc.add_argument("--golden-file", default=None,
                    help="anchor file (default: the config's anchor_path)")
    sc.add_argument("--name", default=None, help="output file prefix")
    sc.add_argument("--threshold", type=float, default=0.5)
    sc.add_argument("--split", default=None, help="reader split (default: from the file name)")
    sc.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sc.set_defaults(fn=cmd_score_corpus)
    _add_bank_parsers(sub)
    bd = sub.add_parser("build-data", help="offline corpus pipeline: splits, CWE anchors, MLM corpus")
    bd.add_argument("--csv", required=True, help="all_samples.csv")
    bd.add_argument("--cve-dict", default=None, help="CVE_dict.json")
    bd.add_argument("--cwe-csv", default=None, help="CWE Research View 1000.csv")
    bd.add_argument("--out", required=True)
    bd.add_argument("--seed", type=int, default=2021)
    bd.add_argument("--full-view-anchors", action="store_true",
                    help="also build the bank of every Research View node")
    bd.set_defaults(fn=cmd_build_data)
    an = sub.add_parser("analyze", help="the paper's analyses over a corpus JSON")
    an.add_argument("corpus", help="corpus JSON (e.g. train_project.json)")
    an.add_argument("--cve-dict", default=None, help="CVE_dict.json")
    an.add_argument("--repo-info", default=None, help="repo star/fork info JSON")
    an.add_argument("-o", "--out", default=None, help="write the report here too")
    an.set_defaults(fn=cmd_analyze)
    sk = sub.add_parser("selfcheck", help="end-to-end acceptance run on a synthetic corpus")
    sk.add_argument("--dir", default=None, help="workspace dir (default: mkdtemp)")
    sk.add_argument("--seed", type=int, default=0)
    sk.add_argument("--projects", type=int, default=8,
                    help="synthetic projects (8 or more keep every split non-empty)")
    sk.add_argument("--reports", type=int, default=24, help="reports per project")
    sk.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sk.set_defaults(fn=cmd_selfcheck)
    trp = sub.add_parser("telemetry-report", help="render a run dir's telemetry (events.jsonl, "
                         "telemetry.json, HEARTBEAT.json, programs.json): phases, step-time "
                         "percentiles, counters, last-heartbeat age; --json for the "
                         "machine-readable report")
    trp.add_argument("run_dir", help="serialization/output dir of a run")
    trp.add_argument("--json", action="store_true", help="the machine-readable report")
    trp.set_defaults(fn=cmd_telemetry_report)
    bl = sub.add_parser("baseline", help="the classical baselines: bag of words, L1-SVC feature "
                        "selection, RF, NB, MLP, LR, KNN")
    bl.add_argument("train_path")
    bl.add_argument("test_path")
    bl.add_argument("-o", "--out-dir", required=True)
    bl.add_argument("--no-feature-selection", action="store_true")
    bl.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    bl.set_defaults(fn=cmd_baseline)
    bn = sub.add_parser("bench", help="the benchmark harness: one JSON record (env knobs: "
                        "memvul_tpu_torch/bench.py; BENCH_DEVICE=cpu runs it on the CPU)")
    bn.set_defaults(fn=cmd_bench)
    tu = sub.add_parser("tune", help="offline autotuner: sweep the training and serving knobs "
                        "for this device class, prune infeasible points, microbench the "
                        "survivors behind the parity gate, persist a versioned tuned profile; "
                        "--cascade tunes the rescue band, --report renders the roofline table")
    tu.add_argument("--mode", choices=("train", "serve", "all"), default="all",
                    help="which knob families to sweep")
    tu.add_argument("--out", default=None, metavar="DIR",
                    help="tuned-profile store root (tuning.profile_dir / "
                    "$MEMVUL_TUNED_PROFILES layout); omit for a dry run")
    tu.add_argument("--cascade", action="store_true",
                    help="also tune [cascade_low, cascade_high] from the golden set's int8 "
                    "score distribution, gated through bankops.evaluate_cascade")
    tu.add_argument("--target-rescore-rate", type=float, default=0.1,
                    help="golden-set fraction the cascade band should rescore")
    tu.add_argument("--report", default=None, metavar="PATH",
                    help="render the roofline markdown from a run dir's programs.json "
                    "instead of tuning")
    tu.add_argument("--splice", default=None, metavar="DOC",
                    help="with --report: splice the generated section into this document")
    tu.add_argument("--device-class", default=None,
                    help="tune for this device class instead of the card's")
    tu.add_argument("--allow-unknown-device", action="store_true",
                    help="tune a class with no PEAK_SPECS row in measurement-only mode "
                    "instead of the unknown_device_class refusal")
    tu.add_argument("--max-programs", type=int, default=64,
                    help="prune ceiling: worst-case step-shape count per candidate")
    tu.add_argument("--hbm-fraction", type=float, default=0.9,
                    help="prune ceiling: fraction of the class's device memory")
    tu.add_argument("--full-space", action="store_true",
                    help="sweep the full knob grids instead of the slim default")
    tu.add_argument("--model", choices=("tiny", "base"), default="tiny",
                    help="microbench model geometry (base is the one that means "
                    "something on the card)")
    tu.add_argument("--seq-len", type=int, default=128)
    tu.add_argument("--batch-size", type=int, default=8, help="training microbench batch size")
    tu.add_argument("--steps", type=int, default=4,
                    help="training microbench optimizer steps per epoch")
    tu.add_argument("--requests", type=int, default=96, help="serving microbench requests")
    tu.add_argument("--clients", type=int, default=4,
                    help="serving microbench closed-loop client threads")
    tu.add_argument("--max-batch", type=int, default=8,
                    help="serving default micro-batch cap (the sweep's center)")
    tu.add_argument("--seed", type=int, default=0)
    tu.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    tu.set_defaults(fn=cmd_tune)
    dr = sub.add_parser("doctor", help="environment/artifact self-diagnosis: device, mesh, "
                        "vocabulary, data artifacts, native normalizer, kernel build dir "
                        "(one JSON report; exit 1 on any failed check)")
    dr.add_argument("--config", default="configs/config_memory.json",
                    help="config whose tokenizer/data paths to check")
    dr.add_argument("--device-timeout", type=float, default=90.0,
                    help="seconds before the device probe counts as wedged")
    dr.add_argument("--skip-device", action="store_true", help="skip the device probe")
    dr.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the probe runs on")
    dr.set_defaults(fn=cmd_doctor)
    pa = sub.add_parser("parity", help="real-weights parity chain: HF convert check, reference-"
                        "archive scoring, metric diff (run on a machine that has the genuine "
                        "bert-base-uncased dir / reference model.tar.gz)")
    pa.add_argument("--hf-dir", required=True,
                    help="local HF checkpoint dir (config.json + torch weights + vocab.txt), "
                    "e.g. bert-base-uncased")
    pa.add_argument("--archive", default=None, help="reference-trained model.tar.gz")
    pa.add_argument("--corpus", default=None, help="test_project.json")
    pa.add_argument("--anchors", default=None, help="CWE_anchor_golden_project.json")
    pa.add_argument("--ref-metrics", default=None,
                    help="metric file the reference pipeline wrote, to diff")
    pa.add_argument("-o", "--out-dir", default="parity_out")
    pa.add_argument("--max-length", type=int, default=512)
    pa.add_argument("--batch-size", type=int, default=512)
    pa.add_argument("--threshold", type=float, default=0.5)
    pa.add_argument("--atol", type=float, default=5e-4,
                    help="convert-parity max-abs-error acceptance")
    pa.add_argument("--seq-len", type=int, default=128,
                    help="convert-parity probe sequence length")
    pa.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pa.set_defaults(fn=cmd_parity)
    li = sub.add_parser("lint", help="static analysis over the port's sources: forward purity, "
                        "lock discipline, handler/artifact hygiene, and fault/metric/config/"
                        "kernel-build drift checks; one AST parse per file, inline "
                        "suppressions + committed baseline")
    from .analysis.cli import add_lint_arguments

    add_lint_arguments(li)
    li.set_defaults(fn=cmd_lint)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    args.argv = argv  # a mesh's launched ranks run the same command
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.command in ("train", "evaluate"):
        try:
            return args.fn(args)
        except (NotImplementedError, MeshSpecError) as e:  # a usage error
            print(f"{args.command}: {e}", file=sys.stderr)
            return 2
    if args.command != "bank":
        return args.fn(args)
    from .bankops import BankStoreError
    from .serving.tenancy import TenantSpecError

    try:
        return args.fn(args)
    except (BankStoreError, TenantSpecError, NotImplementedError) as e:  # a usage error: exit 2
        print(f"bank {args.bank_command}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
