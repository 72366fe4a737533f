"""Command-line interface of the PyTorch/CUDA port.

    python -m memvul_tpu_torch pretrain configs/further_pretrain.json [--export-hf]
    python -m memvul_tpu_torch train configs/config_memory.json -s out/
    python -m memvul_tpu_torch train configs/config_single.json -s out_single/
    python -m memvul_tpu_torch evaluate out/model.tar.gz data/test_project.json -o eval/
    python -m memvul_tpu_torch evaluate ... --overrides "$(cat configs/test_config_memory.json)"
    python -m memvul_tpu_torch evaluate ... --overrides '{"evaluation": {"batch_size": 64}}' --device cpu
    python -m memvul_tpu_torch serve out/model.tar.gz --port 8341 \\
        --overrides '{"serving": {"score_impl": "continuous"}}'

``pretrain`` further-pretrains the encoder with whole-word-mask MLM into
``<output_dir>/encoder.msgpack`` (``--export-hf`` adds an HF checkpoint
under ``<output_dir>/hf``) and prints ``final_loss`` and ``checkpoint``
(with a ``validation_data_path``, ``eval_loss`` and ``perplexity``) as one
JSON line.  ``train`` trains the model a config describes (the memory
model, MemVul-m or TextCNN) into a serialization dir (checkpoints,
``metrics.json``, the best weights as ``model.tar.gz``) and prints the
best epoch and its validation metric as one JSON line.
``evaluate`` prints the metric dict as one JSON line.  ``serve`` puts the
HTTP front end (``POST /score``, ``GET /healthz``) over
``build.serve_from_archive``, prints one JSON line with the bound
``"serving"`` URL once it listens, and drains on SIGTERM/SIGINT.  All four run
on the card (``--device cuda``, the default) unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading


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
    report = pretrain_from_config(config, device=args.device, export_hf=args.export_hf)
    report.pop("train")
    print(json.dumps(report))
    return 0


def cmd_train(args) -> int:
    from .build import train_from_config
    from .config import load_config

    config = load_config(args.config, overrides=args.overrides)
    result = train_from_config(config, args.serialization_dir, device=args.device)
    print(json.dumps({k: result.get(k) for k in ("best_epoch", "best_validation", "archive")}))
    return 0


def cmd_evaluate(args) -> int:
    from .build import evaluate_from_archive

    metrics = evaluate_from_archive(
        args.archive, args.test_path, args.out_dir,
        overrides=args.overrides, golden_file=args.golden_file, name=args.name,
        thres=args.threshold, device=args.device,
    )
    print(json.dumps(metrics, default=float))
    return 0


def cmd_serve(args) -> int:
    from .build import serve_from_archive
    from .serving.frontend import run_http_server

    try:
        service = serve_from_archive(
            args.archive, out_dir=args.out_dir, overrides=args.overrides,
            golden_file=args.golden_file, device=args.device,
        )
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    server = run_http_server(service, host=args.host, port=args.port)
    stop = threading.Event()

    def _stop_handler(signum, frame):
        service.request_drain()
        stop.set()

    previous = [(sig, signal.signal(sig, _stop_handler)) for sig in (signal.SIGTERM, signal.SIGINT)]
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}", "pid": os.getpid(), "replicas": 1}), flush=True)
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        server.shutdown()
        service.drain()
        for sig, handler in previous:
            signal.signal(sig, handler)
    return 0


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
    pt.set_defaults(fn=cmd_pretrain)
    tr = sub.add_parser("train", help="train the model a config describes")
    tr.add_argument("config", help="training config (JSON / Jsonnet subset)")
    tr.add_argument("-s", "--serialization-dir", required=True)
    tr.add_argument("-o", "--overrides", default=None,
                    help="JSON (Jsonnet subset) config overrides")
    tr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
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
    ev.set_defaults(fn=cmd_evaluate)
    sv = sub.add_parser("serve", help="online scoring service over HTTP")
    sv.add_argument("archive", help="model.tar.gz or a serialization dir holding one")
    sv.add_argument("-o", "--out-dir", default=None, help="telemetry.json lands here at drain")
    sv.add_argument("--overrides", default=None, help="JSON (Jsonnet subset) config overrides")
    sv.add_argument("--golden-file", default=None, help="anchor file (default: the config's anchor_path)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8341, help="0 binds an ephemeral port")
    sv.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sv.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
