"""Command-line interface of the PyTorch/CUDA port.

    python -m memvul_tpu_torch evaluate out/model.tar.gz data/test_project.json -o eval/
    python -m memvul_tpu_torch evaluate ... --overrides '{"evaluation": {"batch_size": 64}}' --device cpu

``evaluate`` runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given, and prints the metric dict as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def cmd_evaluate(args) -> int:
    from .build import evaluate_from_archive

    metrics = evaluate_from_archive(
        args.archive, args.test_path, args.out_dir,
        overrides=args.overrides, golden_file=args.golden, name=args.name,
        thres=args.thres, device=args.device,
    )
    print(json.dumps(metrics, default=float))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m memvul_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    ev = sub.add_parser("evaluate", help="score a corpus with an archived memory model")
    ev.add_argument("archive", help="model.tar.gz or a serialization dir holding one")
    ev.add_argument("test_path", help="corpus file (.json array or .jsonl)")
    ev.add_argument("-o", "--out-dir", required=True)
    ev.add_argument("--overrides", default=None, help="JSON (Jsonnet subset) config overrides")
    ev.add_argument("--golden", default=None, help="anchor file (default: the config's anchor_path)")
    ev.add_argument("--name", default=None, help="output file prefix (default: the model type)")
    ev.add_argument("--thres", type=float, default=0.5)
    ev.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ev.set_defaults(fn=cmd_evaluate)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
