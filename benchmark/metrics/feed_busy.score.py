"""Share of the scoring stream's wall time in which rank 0's feed thread
tokenized (``feed.tokenize``) or collated (``feed.collate``): program spans
(``lib/spans.py``), over the stream from its first call to its end."""

from benchmark.lib import spans


def read(run):
    found = [s for s in spans.program_spans(run) or ()
             if s[spans.NAME] in ("feed.tokenize", "feed.collate")]
    return spans.stream_share(run, spans.seconds_of(found)) if found else None
