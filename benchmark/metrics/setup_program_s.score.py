"""Seconds of set-up in the program's own set-up spans: the outermost
``kernels.load`` (the kernel library's build and load), ``anchor_encode``
and ``aot_warmup`` spans of rank 0 (``lib/spans.py``).  The rest of
``setup_s`` is the harness, the imports and the CUDA context."""

from benchmark.lib import spans


def read(run):
    found = [s for s in spans.program_spans(run) or ()
             if s[spans.PARENT] is None and s[spans.NAME] in spans.SETUP]
    return spans.seconds_of(found) if found else None
