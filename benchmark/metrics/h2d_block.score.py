"""Share of the scoring stream's wall time in which rank 0's launch thread
copied batches to the card: the program's ``score.h2d`` spans inside its
``score.launch`` spans (``lib/spans.py``), over the stream from its first
call to its end.  With ``launch_self.score`` it splits
``host_launch.score``."""

from benchmark.lib import spans


def read(run):
    _, h2d = spans.launch_split(run)
    return spans.stream_share(run, h2d)
