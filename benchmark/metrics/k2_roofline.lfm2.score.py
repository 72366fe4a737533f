"""K2 (``flash_fwd*`` kernels) in the LFM2 cell against its causal roofline
on rank 0: for each launch in the trace, the least time its shape could
take (``lib/cost_lfm2.py``: the larger of its causal FLOPs over the bf16
peak and its bytes over the HBM peak), summed, over the launches' summed
device time.  Launches map to batches in launch order, one per attention
layer of each batch."""

from benchmark.lib import cost_lfm2


def read(run):
    trace = run.get("trace")
    cfg = run["config"]
    if not trace or cfg.get("model_type") != "lfm2_moe":
        return None
    layers = sum(t == "full_attention" for t in cfg["layer_types"])
    kernels = [(s, e) for name, s, e in trace["device"] if "flash_fwd" in name]
    if not kernels:
        return None
    launches = run["launches"]
    if len(kernels) > layers * len(launches):
        raise RuntimeError(f"{len(kernels)} attention launches for {len(launches)} batches")
    bound = spent = 0.0
    for k, (s, e) in enumerate(kernels):
        rows, length = launches[k // layers]
        bound += cost_lfm2.roofline_seconds(*cost_lfm2.attention_launch(cfg, rows, length))
        spent += (e - s) / 1e9
    return 100.0 * bound / spent
