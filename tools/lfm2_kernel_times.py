"""Device times of the LFM2 encoder's kernels at its cell's shapes, for the
kernel table: K2 causal and grouped (32 query / 8 K/V heads of 64) at each
bucket of 262144 tokens, and K5's two products at one MoE layer's routing
of 262144 slots (top 4 of 32 experts, widths 2048 / 1792), each beside its
roofline bound, its plain version and one PyTorch call that computes the
same function (a yardstick only: the port never calls it).

    python tools/lfm2_kernel_times.py [--reps 5] > times.jsonl

One JSON line a shape; times are the median of ``--reps`` launches timed
with CUDA events, after one untimed launch.
"""

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from memvul_tpu_torch.ops import flash_attention as fa  # noqa: E402
from memvul_tpu_torch.ops import moe  # noqa: E402
from memvul_tpu_torch.ops.attention import mask_to_bias  # noqa: E402

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
TOKENS = 262144


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def attention_rows(reps):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for t in (64, 128, 256, 512, 1024, 2048, 4096):
        b = TOKENS // t
        q = (torch.randn(b, t, 32, 64, device="cuda", generator=gen) * 2).to(torch.bfloat16)
        k = (torch.randn(b, t, 8, 64, device="cuda", generator=gen) * 2).to(torch.bfloat16)
        v = torch.randn(b, t, 8, 64, device="cuda", generator=gen).to(torch.bfloat16)
        bias = mask_to_bias(torch.ones(b, t, dtype=torch.int32, device="cuda"), torch.float32)
        flops = 2.0 * b * 32 * 64 * t * (t + 1)
        nbytes = 2.0 * b * t * 64 * (2 * 32 + 2 * 8) + 4.0 * b * t
        row = {"kernel": "K2 causal", "shape": [b, t, 32, 8, 64],
               "bound_ms": max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3,
               "kernel_ms": timed(lambda: fa.flash_attention(q, k, v, bias, causal=True), reps),
               "plain_ms": timed(lambda: fa.flash_attention_reference(q, k, v, bias, causal=True), 1)}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["library_ms"] = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps)
        print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt


def expert_rows(reps):
    gen = torch.Generator(device="cuda").manual_seed(1)
    d, f, e, top_k = 2048, 1792, 32, 4
    x = torch.randn(TOKENS, d, device="cuda", generator=gen).to(torch.bfloat16)
    gate = (torch.randn(e, d, device="cuda", generator=gen) / math.sqrt(d)).to(torch.bfloat16)
    selected, _ = moe.route(x, gate, None, top_k)
    order, offsets = moe.dispatch(selected, e)
    rows = x.index_select(0, torch.div(order, top_k, rounding_mode="floor"))
    w13 = (torch.randn(e, 2 * f, d, device="cuda", generator=gen) / math.sqrt(d)).to(torch.bfloat16)
    w2 = (torch.randn(e, d, f, device="cuda", generator=gen) / math.sqrt(f)).to(torch.bfloat16)
    pairs = rows.shape[0]
    hidden = moe.grouped_gemm(rows, w13, offsets, swiglu=True)
    counts = (offsets[1:] - offsets[:-1]).tolist()
    for name, a, w, swiglu, n_in, n_out in (("w13 + SwiGLU", rows, w13, True, d, f),
                                            ("w2", hidden, w2, False, f, d)):
        flops = 2.0 * pairs * w.shape[1] * w.shape[2]
        nbytes = 2.0 * w.numel() + 2.0 * pairs * (n_in + n_out)

        def library():
            # one cuBLAS product an expert, the counts known on the host
            outs = list(torch.split(a, counts))
            return [o @ w[i].t() for i, o in enumerate(outs)]

        print(json.dumps({
            "kernel": "K5 " + name, "shape": [pairs, w.shape[2], e, w.shape[1]],
            "expert_rows": [min(counts), max(counts)],
            "bound_ms": max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "kernel_ms": timed(lambda: moe.grouped_gemm(a, w, offsets, swiglu=swiglu), reps),
            "plain_ms": timed(lambda: moe.grouped_gemm_reference(a, w, offsets, swiglu), 1),
            "library_ms": timed(library, reps)}), flush=True)


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    attention_rows(args.reps)
    expert_rows(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
