"""Share of the scoring stream's wall time the predictor spent enqueueing
batches' work on the card: the program's ``stats["launch_s"]`` over the
stream from its first call to its end, on rank 0."""


def read(run):
    s = run["stream"]
    return 100.0 * s["launch_s"] / s["seconds"]
