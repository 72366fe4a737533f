"""The useful FLOPs of the LFM2 cell's reports whose answers came back
inside the window, counted at their real lengths after truncation
(``lib/cost_lfm2.py``: projections, dense FFNs, the router and the k experts
a token takes, the conv, causal attention, the header and the anchor match),
as a share of what the cell's cards could do at their bf16 peak over the
window."""

from benchmark.lib import cost_lfm2


def read(run):
    if run["config"].get("model_type") != "lfm2_moe":
        return None
    flops = cost_lfm2.useful_flops(run["config"], run["lengths_in_window"], run["n_anchors"])
    return 100.0 * flops / (run["window_s"] * cost_lfm2.PEAK_BF16_FLOPS * run["chips"])
