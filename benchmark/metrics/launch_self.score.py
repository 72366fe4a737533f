"""Share of the scoring stream's wall time that rank 0's launch thread spent
in ``score.launch`` outside its copies to the card (``score.h2d``): the
enqueue of a batch's work, program spans (``lib/spans.py``), over the
stream from its first call to its end."""

from benchmark.lib import spans


def read(run):
    launch, h2d = spans.launch_split(run)
    return spans.stream_share(run, None if launch is None else launch - h2d)
