"""Write an archive of an LFM2 memory model with seeded random weights, so
that ``python -m memvul_tpu_torch evaluate`` can score a corpus with it (no
trained LFM2 MemVul exists, and training refuses the encoder).

    python tools/lfm2_archive.py configs/config_memory_lfm2.json WORKSPACE OUT.tar.gz \
        [--seed 0] [--device cuda] [--encoder '{"num_hidden_layers": 4, ...}']

``WORKSPACE`` is a directory of ``memvul_tpu_torch.data.synthetic.
build_workspace`` (made there when it has none): its tokenizer goes into the
archive, and its CVE and anchor files into the archived config's
``dataset_reader``.  The model is built on the meta device and drawn on
``--device`` in its own dtype (the published model: 16.7 GB of bf16), then
written with :func:`memvul_tpu_torch.models.convert.lfm2_params`.  Then:

    python -m memvul_tpu_torch evaluate OUT.tar.gz WORKSPACE/test_project.json -o EVAL_DIR
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from memvul_tpu_torch.archive import save_archive  # noqa: E402
from memvul_tpu_torch.build import build_model  # noqa: E402
from memvul_tpu_torch.config import load_config  # noqa: E402
from memvul_tpu_torch.data.synthetic import build_workspace  # noqa: E402
from memvul_tpu_torch.models.bert import init_weights  # noqa: E402
from memvul_tpu_torch.models.convert import lfm2_params  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("workspace")
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--encoder", default="{}", help="JSON keys over the encoder section")
    args = p.parse_args(argv)
    config = load_config(args.config)
    config["model"]["encoder"].update(json.loads(args.encoder))
    ws = build_workspace(Path(args.workspace).resolve(), seed=args.seed)
    config["tokenizer"] = {"type": "wordpiece"}
    config["dataset_reader"].update(cve_path=ws["paths"]["cve"], anchor_path=ws["paths"]["anchors"])
    with torch.device("meta"):
        model = build_model(config["model"], ws["tokenizer"].vocab_size)
    model = model.to_empty(device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    with torch.no_grad():
        model.model.reset_parameters(gen)
        init_weights(model.header, model.config.initializer_range, generator=gen)
        model.pair_kernel.normal_(0.0, model.config.initializer_range, generator=gen)
    path = save_archive(args.out, config, lfm2_params(model), tokenizer_file=ws["paths"]["tokenizer"])
    print(json.dumps({"archive": str(path), "bytes": path.stat().st_size,
                      "parameters": sum(t.numel() for t in model.parameters()),
                      "test": str(ws["paths"]["test"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
