"""The useful FLOPs of the reports whose answers came back inside the
window, counted at their real lengths after truncation (encoder, attention,
pooler, header and anchor match; ``lib/cost.py``), as a share of what the
cell's cards could do at their bf16 peak over the window."""

from benchmark.lib import cost


def read(run):
    flops = cost.useful_flops(run["config"], run["lengths_in_window"], run["n_anchors"])
    return 100.0 * flops / (run["window_s"] * cost.PEAK_BF16_FLOPS * run["chips"])
