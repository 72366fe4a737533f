"""Sharded, supervised corpus scoring (the JAX package's ``distributed/``,
``python -m memvul_tpu_torch score-corpus``).

* :func:`partition.partition_rows` — the contiguous row spans, a pure
  function of (corpus length, shard count);
* ``worker`` — one subprocess per shard, running the resumable
  ``predict_file`` over its span with its own journal, dead-letter file and
  ``HEARTBEAT.json``, on the card unless its spec says ``"cpu"``;
* :func:`coordinator.score_corpus` — launches and supervises the workers
  (heartbeat-age stall detection, exit-code death detection, exponential
  backoff restarts, quarantine after ``max_shard_attempts``), then merges
  their outputs in partition order under an exactly-once verification pass.

On one card the workers share it (time-sliced between their contexts):
sharding buys supervision and resume there, not speed.
"""

from .coordinator import MergeVerificationError, PartialCompletionError, score_corpus  # noqa: F401
from .partition import partition_rows  # noqa: F401
