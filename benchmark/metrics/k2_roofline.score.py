"""The attention kernel K2 (``flash_fwd*`` kernels) against its roofline on
rank 0: for each launch in the trace, the least time its shape could take
(the larger of its FLOPs over the bf16 peak and its bytes over the HBM
peak), summed, over the launches' summed device time.  Launches map to
batches in launch order, one per layer of each batch."""

from benchmark.lib import cost


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    cfg = run["config"]
    layers = int(cfg["num_hidden_layers"])
    heads = int(cfg["num_attention_heads"])
    head_dim = int(cfg["hidden_size"]) // heads
    kernels = [(s, e) for name, s, e in trace["device"] if "flash_fwd" in name]
    if not kernels:
        return None
    launches = run["launches"]
    if len(kernels) > layers * len(launches):
        raise RuntimeError(f"{len(kernels)} attention launches for {len(launches)} batches")
    bound = spent = 0.0
    for k, (s, e) in enumerate(kernels):
        rows, length = launches[k // layers]
        bound += cost.roofline_seconds(*cost.attention_launch(rows, length, heads, head_dim))
        spent += (e - s) / 1e9
    return 100.0 * bound / spent
