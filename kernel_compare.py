"""Time the port's kernels of this checkout, in turns on one card, against
the same kernels of other checkouts and against variants of this one, at
the shapes the paths launch them with.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 kernel_compare.py [--split] [--kernels=flash,ragged,anchor_match] [TREE ...]

* each ``TREE`` is the root of another checkout, for example the parent
  commit's (``git archive <commit> | tar -x -C build/parent``, then
  ``build/parent``).  Its own wrappers (``memvul_tpu_torch/ops``) are
  loaded under another package name, and build its own sources into its
  own ``build/kernels``, so a tree whose C entry points differ from this
  one's still compares;
* ``ragged_keys_128`` is always built beside them: this tree's K3 with
  128-key K/V tiles in place of 64;
* ``--split`` adds variants of this tree's kernels, built from their
  sources with one edit each.  For K2 ``products_only`` (no softmax: S is
  packed into P as it comes) and ``softmax_only`` (no wgmma issued); for K3
  the same two as ``ragged_products_only`` and ``ragged_softmax_only``,
  ``ragged_pipeline_only`` (neither: the prologue, the loads and the
  epilogue), a ring of 4 stages (``ragged_stages_4``) and the blocks in
  (batch, head)-major order, the query tiles of one head consecutive
  (``ragged_head_major``).  Those
  outputs are meaningless; their times say which part bounds the kernel.
  For K1 the D split aiming at 4 blocks per SM (``anchor_blocks_per_sm_4``)
  and clusters of at most 4 (``anchor_split_4``);
* ``--kernels`` picks which kernels to time (all three by default).

For each shape it prints one JSON line with every kernel's times, taken
in the order A, B, ..., ..., B, A, and the largest difference between this
tree's output and each other one's.  K2 (flash) is timed by CUDA events
over 5 launches after one warm-up, with SDPA's time beside it; K3
(ragged: the serve pack and a [1, 16384] pack) and K1 (anchor_match: every
row count the paths launch it with) by their device time from the
profiler over 20 launches, since a launch of theirs is shorter than the
host takes to make it.  Then the card's name and power limit.  Variants
are built under ``build/kernel_compare/``.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import chip_smoke as cs

OUT = cs.ROOT / "build" / "kernel_compare"

RAGGED_NO_SOFTMAX = ("  auto softmax = [&](int it) {\n    const int* ss", "  // P rounded to bf16 as A fragments",
                     "  auto softmax = [&](int it) { corr0 = corr1 = 1.f; l0 += sc[0]; l1 += sc[2]; };\n")
RAGGED_NO_PRODUCTS = [
    ("      wgmma_qk<KT>(", None, "      if (Tn < 0) wgmma_qk<KT>("),
    ("    for (int j = 0; j < KT / 16; ++j) wgmma_m64n64k16_rs(", None,
     "    for (int j = 0; j < KT / 16; ++j) if (Tn < 0) wgmma_m64n64k16_rs("),
]
# name: (source, [(start marker, end marker or None, replacement)]) of each
# variant of this tree's sources: with an end marker, the text from start
# to end is replaced; without one, the start marker itself is
VARIANTS = {
    "products_only": ("flash_fwd.cu", [
        ("  auto softmax = [&](int it) {\n", "  // P rounded to bf16 as A fragments",
         "  auto softmax = [&](int it) { corr0 = corr1 = 1.f; l0 += sc[0]; l1 += sc[2]; };\n"),
    ]),
    "softmax_only": ("flash_fwd.cu", [
        ("      wgmma_m64n128k16_ss(", None, "      if (Tq < 0) wgmma_m64n128k16_ss("),
        ("    for (int j = 0; j < kWgKeys / 16; ++j) wgmma_m64n64k16_rs(", None,
         "    for (int j = 0; j < kWgKeys / 16; ++j) if (Tq < 0) wgmma_m64n64k16_rs("),
    ]),
    "ragged_keys_128": ("ragged_fwd.cu", [
        ("constexpr int kRgKeys = 64;", None, "constexpr int kRgKeys = 128;"),
    ]),
    "anchor_blocks_per_sm_4": ("anchor_match.cu", [
        ("constexpr int kBlocksPerSm = 2;", None, "constexpr int kBlocksPerSm = 4;"),
    ]),
    "anchor_split_4": ("anchor_match.cu", [
        ("constexpr int kMaxSplit = 8;", None, "constexpr int kMaxSplit = 4;"),
    ]),
    "ragged_stages_4": ("ragged_fwd.cu", [
        ("constexpr int kRgStages = 3;", None, "constexpr int kRgStages = 4;"),
    ]),
    "ragged_head_major": ("ragged_fwd.cu", [
        ("  const int qtile = blockIdx.x / (B * H), b = blockIdx.x % (B * H) / H, h = blockIdx.x % H;",
         None,
         "  const int qtile = blockIdx.x % n_qtiles, b = blockIdx.x / n_qtiles / H,\n"
         "            h = blockIdx.x / n_qtiles % H;"),
    ]),
    "ragged_products_only": ("ragged_fwd.cu", [RAGGED_NO_SOFTMAX]),
    "ragged_softmax_only": ("ragged_fwd.cu", RAGGED_NO_PRODUCTS),
    "ragged_pipeline_only": ("ragged_fwd.cu", [RAGGED_NO_SOFTMAX, *RAGGED_NO_PRODUCTS]),
}
SPLITS = {"flash": ["products_only", "softmax_only"],
          "ragged": ["ragged_stages_4", "ragged_head_major", "ragged_products_only",
                     "ragged_softmax_only", "ragged_pipeline_only"],
          "anchor_match": ["anchor_blocks_per_sm_4", "anchor_split_4"]}
KERNELS = ("flash", "ragged", "anchor_match")


def build_variant(csrc: Path, name: str) -> ctypes.CDLL:
    """The kernel library built from a variant of this tree's sources, with
    this tree's entry points."""
    from memvul_tpu_torch.ops import _kernels

    own = (_kernels.CSRC, _kernels.BUILD_DIR)
    _kernels.CSRC, _kernels.BUILD_DIR = csrc.resolve(), OUT / name / "lib"
    try:
        lib = ctypes.CDLL(str(_kernels.build(force=True)))
    finally:
        _kernels.CSRC, _kernels.BUILD_DIR = own
    for fn_name, argtypes in _kernels.PROTOTYPES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.memvul_error_string.argtypes = [ctypes.c_int]
    lib.memvul_error_string.restype = ctypes.c_char_p
    return lib


def load_tree(root: Path, alias: str) -> dict:
    """Another checkout's kernel wrappers, imported as package ``alias``:
    {"flash": ..., "ragged": ..., "anchor_match": ...} modules."""
    pkg = root.resolve() / "memvul_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return {key: importlib.import_module(f"{alias}.ops.{name}") for key, name in
            (("flash", "flash_attention"), ("ragged", "ragged_attention"),
             ("anchor_match", "anchor_match"))}


def variant_source(name: str) -> Path:
    """This tree's csrc with one variant's edits."""
    from memvul_tpu_torch.ops import _kernels

    dst = OUT / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_kernels.CSRC, dst)
    source, edits = VARIANTS[name]
    text = (dst / source).read_text()
    for start, end, replacement in edits:
        if start not in text or (end is not None and end not in text):
            raise SystemExit(f"kernel_compare: {name}: marker not found in {source}: {start!r}")
        if end is None:
            text = text.replace(start, replacement)
        else:
            i = text.index(start)
            text = text[:i] + replacement + text[text.index(end, i):]
    (dst / source).write_text(text)
    return dst


def in_turns(calls: dict, timer) -> dict:
    """Each kernel's output and times, {name: call}, taken in the order A,
    B, ..., ..., B, A; "this" first."""
    names = list(calls)
    row = {f"{name}_ms": [] for name in names}
    outs = {}
    for name in names + names[::-1]:
        outs[name] = calls[name]()
        row[f"{name}_ms"].append(timer(calls[name]))
    for name in names[1:]:
        row[f"{name}_max_abs_diff"] = float((outs["this"].float() - outs[name].float()).abs().max())
        row[f"{name}_over_this"] = min(row[f"{name}_ms"]) / min(row["this_ms"])
    return row


def main(argv) -> int:
    import torch
    import torch.nn.functional as F

    split = "--split" in argv
    kernels = next((a.split("=", 1)[1].split(",") for a in argv if a.startswith("--kernels=")),
                   list(KERNELS))
    trees = [Path(a) for a in argv if not a.startswith("--")]
    if not torch.cuda.is_available() or set(kernels) - set(KERNELS):
        print(__doc__, file=sys.stderr)
        return 2
    from memvul_tpu_torch.ops import _kernels
    from memvul_tpu_torch.ops import anchor_match as am
    from memvul_tpu_torch.ops import flash_attention as fa
    from memvul_tpu_torch.ops import ragged_attention as ra

    this = _kernels.library()
    refs = {f"ref{i}": load_tree(tree, f"kernel_compare_ref{i}") for i, tree in enumerate(trees)}
    variants = {name: build_variant(variant_source(name), name)
                for name in ["ragged_keys_128"] + [v for k in kernels if split for v in SPLITS.get(k, [])]}

    def on(lib, fn):
        """fn with this tree's wrappers launching from ``lib``."""
        def call():
            _kernels._lib = lib
            try:
                return fn()
            finally:
                _kernels._lib = this
        return call

    def calls(kernel, own, ref_fn, variant_names):
        return {"this": on(this, own), **{name: ref_fn(mods[kernel]) for name, mods in refs.items()},
                **{name: on(variants[name], own) for name in variant_names}}

    gen = torch.Generator(device="cuda").manual_seed(1)
    if "flash" in kernels:
        for b, t in cs.main_path_flash_shapes():
            q, k, v, bias = cs._flash_inputs(b, t, 12, 64, torch.bfloat16, gen)
            run = calls("flash", lambda: fa.flash_attention(q, k, v, bias),
                        lambda mod: (lambda: mod.flash_attention(q, k, v, bias)),
                        SPLITS["flash"] if split else [])
            row = {"kernel": "flash", "shape": [b, t, 12, 64], **in_turns(run, lambda fn: cs.time_ms(fn, 5))}
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["sdpa_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5)
            print(json.dumps(row), flush=True)
            del q, k, v, bias

    if "ragged" in kernels:
        for case, (budget, cap) in (("serve_pack", (2048, 512)), ("long_pack", (16384, 4096))):
            seg_np, lens = cs._realistic_pack(budget, cap)
            seg = torch.as_tensor(seg_np, device="cuda")
            q, k, v = ((torch.randn(1, budget, 12, 64, device="cuda", generator=gen) * s)
                       .to(torch.bfloat16) for s in (2.0, 2.0, 1.0))
            packed = ra.pack_segments(seg)

            def ref_call(mod):
                ref_packed = mod.pack_segments(seg)
                return lambda: mod.ragged_flash_attention(q, k, v, ref_packed)

            run = calls("ragged", lambda: ra.ragged_flash_attention(q, k, v, packed), ref_call,
                        ["ragged_keys_128", *(SPLITS["ragged"] if split else [])])
            row = {"kernel": "ragged", "case": case, "shape": [1, budget, 12, 64], "row_tokens": lens,
                   **in_turns(run, lambda fn: cs.device_ms(fn, 20))}
            print(json.dumps(row), flush=True)

    if "anchor_match" in kernels:
        for b in cs.ANCHOR_ROWS:
            u, v, w = ((torch.randn(*shape, device="cuda", generator=gen) * s).to(torch.bfloat16)
                       for shape, s in (((b, 512), 1.0), ((129, 512), 1.0), ((1536, 2), 0.1)))
            run = calls("anchor_match", lambda: am.fused_anchor_match(u, v, w),
                        lambda mod: (lambda: mod.fused_anchor_match(u, v, w)),
                        SPLITS["anchor_match"] if split else [])
            row = {"kernel": "anchor_match", "shape": [b, 129, 512, 2],
                   **in_turns(run, lambda fn: cs.device_ms(fn, 20))}
            print(json.dumps(row), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
