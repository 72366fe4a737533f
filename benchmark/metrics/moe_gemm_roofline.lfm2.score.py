"""K5 (``grouped_gemm*`` kernels) in the LFM2 cell against its roofline on
rank 0: for each MoE layer whose two expert products are in the trace, the
least time the layer's products could take (``lib/cost_lfm2.py``: the
larger of ``2·P·3·D·F`` FLOPs over the bf16 peak and the weights once plus
the pairs' rows in and out over the HBM peak, P = B·T·k), summed, over the
products' summed device time.  Launches map to batches in launch order,
two per MoE layer of each batch."""

from benchmark.lib import cost_lfm2


def read(run):
    trace = run.get("trace")
    cfg = run["config"]
    if not trace or cfg.get("model_type") != "lfm2_moe":
        return None
    layers = int(cfg["num_hidden_layers"]) - int(cfg["num_dense_layers"])
    kernels = [(s, e) for name, s, e in trace["device"] if "grouped_gemm" in name]
    kernels = kernels[: len(kernels) // 2 * 2]  # whole layers only
    if not kernels:
        return None
    launches = run["launches"]
    if len(kernels) > 2 * layers * len(launches):
        raise RuntimeError(f"{len(kernels)} expert products for {len(launches)} batches")
    bound = spent = 0.0
    for k in range(0, len(kernels), 2):
        rows, length = launches[k // (2 * layers)]
        bound += cost_lfm2.roofline_seconds(*cost_lfm2.moe_layer(cfg, rows, length))
        spent += sum((e - s) / 1e9 for s, e in kernels[k : k + 2])
    return 100.0 * bound / spent
