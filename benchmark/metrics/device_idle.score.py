"""Share of the traced window in which no operation ran on the card, as the
mean over the cell's cards (each rank's share is on an earlier line of the
run's output)."""


def read(run):
    ranks = run.get("ranks")
    if not ranks or any(r is None for r in ranks):
        return None
    if not any(r["busy_s"] > 0 for r in ranks):
        return None
    return 100.0 * sum(1.0 - r["busy_s"] / r["window_s"] for r in ranks) / len(ranks)
