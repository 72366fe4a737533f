"""Time flash attention (K2) of this checkout, in turns on one card, against
K2 built from other CUDA sources, at the shapes the main path launches it
with.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 flash_compare.py [--split] [CSRC_DIR ...]

* each ``CSRC_DIR`` is another tree's ``memvul_tpu_torch/csrc``, for
  example the parent commit's (``git archive <commit> | tar -x -C
  build/parent``, then ``build/parent/memvul_tpu_torch/csrc``);
* ``--split`` adds two variants of this tree's wgmma kernel, built from
  its source with one part cut out: ``products_only`` (no softmax: S is
  packed into P as it comes) and ``softmax_only`` (no wgmma issued).
  Their outputs are meaningless; their times say which part bounds the
  kernel.

For each shape it prints one JSON line with every kernel's times, taken in
the order A, B, ..., ..., B, A (CUDA events, 5 launches each after one
warm-up), SDPA's time beside them, and the largest difference between this
tree's output and each other tree's; then the card's name and power limit.
Other libraries are built under ``build/flash_compare/``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

import chip_smoke as cs

OUT = cs.ROOT / "build" / "flash_compare"

# (name, [(start marker, end marker or None, replacement)]) of each part cut
# out of flash_fwd.cu: with an end marker, the text from start to end is
# replaced; without one, the start marker itself is
SPLITS = {
    "products_only": [
        ("  auto softmax = [&](int it) {\n", "  // P rounded to bf16 as A fragments",
         "  auto softmax = [&](int it) { corr0 = corr1 = 1.f; l0 += sc[0]; l1 += sc[2]; };\n"),
    ],
    "softmax_only": [
        ("      wgmma_m64n128k16_ss(", None, "      if (Tq < 0) wgmma_m64n128k16_ss("),
        ("    for (int j = 0; j < kWgKeys / 16; ++j) wgmma_m64n64k16_rs(", None,
         "    for (int j = 0; j < kWgKeys / 16; ++j) if (Tq < 0) wgmma_m64n64k16_rs("),
    ],
}


def build_library(csrc: Path, name: str) -> ctypes.CDLL:
    """K2's entry point built from ``csrc``, loaded beside this tree's."""
    from memvul_tpu_torch.ops import _kernels

    own = (_kernels.CSRC, _kernels.BUILD_DIR)
    _kernels.CSRC, _kernels.BUILD_DIR = csrc.resolve(), OUT / name / "lib"
    try:
        lib = ctypes.CDLL(str(_kernels.build(force=True)))
    finally:
        _kernels.CSRC, _kernels.BUILD_DIR = own
    lib.memvul_flash_fwd.argtypes = _kernels.PROTOTYPES["memvul_flash_fwd"]
    lib.memvul_flash_fwd.restype = ctypes.c_int
    lib.memvul_error_string.argtypes = [ctypes.c_int]
    lib.memvul_error_string.restype = ctypes.c_char_p
    return lib


def split_source(name: str) -> Path:
    """This tree's csrc with one part of the wgmma kernel cut out."""
    from memvul_tpu_torch.ops import _kernels

    dst = OUT / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_kernels.CSRC, dst)
    text = (dst / "flash_fwd.cu").read_text()
    for start, end, replacement in SPLITS[name]:
        if start not in text or (end is not None and end not in text):
            raise SystemExit(f"flash_compare: {name}: marker not found in flash_fwd.cu: {start!r}")
        if end is None:
            text = text.replace(start, replacement)
        else:
            i = text.index(start)
            text = text[:i] + replacement + text[text.index(end, i):]
    (dst / "flash_fwd.cu").write_text(text)
    return dst


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    split = "--split" in argv
    refs = [Path(a) for a in argv if a != "--split"]
    if not torch.cuda.is_available() or not (split or refs):
        print(__doc__, file=sys.stderr)
        return 2
    from memvul_tpu_torch.ops import _kernels
    from memvul_tpu_torch.ops import flash_attention as fa

    libs = {"this": _kernels.library()}
    for i, ref in enumerate(refs):
        libs[f"ref{i}"] = build_library(ref, f"ref{i}")
    if split:
        for name in SPLITS:
            libs[name] = build_library(split_source(name), name)
    order = list(libs) + list(libs)[::-1]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, t in cs.main_path_flash_shapes():
        q, k, v, bias = cs._flash_inputs(b, t, 12, 64, torch.bfloat16, gen)
        row = {"shape": [b, t, 12, 64], **{f"{name}_ms": [] for name in libs}}
        outs = {}
        for name in order:
            _kernels._lib = libs[name]
            outs[name] = fa.flash_attention(q, k, v, bias)
            row[f"{name}_ms"].append(cs.time_ms(lambda: fa.flash_attention(q, k, v, bias), 5))
        _kernels._lib = libs["this"]
        for i in range(len(refs)):
            diff = (outs["this"].float() - outs[f"ref{i}"].float()).abs().max()
            row[f"ref{i}_max_abs_diff"] = float(diff)
            row[f"ref{i}_over_this"] = min(row[f"ref{i}_ms"]) / min(row["this_ms"])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5)
        print(json.dumps(row), flush=True)
        del q, k, v, bias, outs
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
