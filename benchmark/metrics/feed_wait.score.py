"""Share of the scoring stream's wall time in which the predictor waited on
its feed thread (tokenization and batching): the program's
``stats["feed_wait_s"]`` over the stream from its first call to its end,
on rank 0."""


def read(run):
    s = run["stream"]
    return 100.0 * s["feed_wait_s"] / s["seconds"]
