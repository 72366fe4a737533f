"""The offline autotuner (the JAX package's ``tuning/``).

Training bucket grids, the dedup capacity ladder, prefetch depth, the
serving ``token_budget`` / ``max_rows_per_pack`` / micro-batch caps and
the cascade rescue band are hand-set config; the program registry
(``telemetry/programs.py``) counts each program's work and device memory.
This package closes that loop offline, for one device class at a time:

* :mod:`.knobs` — the candidate space (training and serving knob grids;
  no kernel tile size is a knob, as in the JAX package);
* :mod:`.prune` — analytic feasibility through the registry's measured
  device memory and the ``PEAK_SPECS`` row (memory overflow, step-shape
  count blowups) BEFORE a candidate costs a run;
* :mod:`.microbench` — short seeded in-process microbenches (the
  primitives of ``BENCH_MICRO=train_step`` / ``serve``) scoring the
  survivors on the card;
* :mod:`.parity` — the mandatory gate: layout-only serving candidates
  must reproduce a fixed probe set's scores bitwise, training collation
  candidates the loss trajectory within ``LOSS_TOL``; an impl change goes
  through ``bankops.evaluate_gate``.  Tuning can change speed, never
  results;
* :mod:`.cascade` — the ``[cascade_low, cascade_high]`` band, gated by
  ``bankops.evaluate_cascade``;
* :mod:`.profile` — the versioned, sha256-manifested tuned profile per
  device class that ``build.train_from_config`` /
  ``build.serve_from_archive`` load (explicit config always wins; an
  untuned class runs on the shipped defaults);
* :mod:`.report` — the roofline table renderer (``tune --report``);
* :mod:`.autotune` — the orchestration ``python -m memvul_tpu_torch
  tune`` drives.
"""

from .knobs import Candidate, serve_space, train_space  # noqa: F401
from .profile import (  # noqa: F401
    PROFILE_SCHEMA,
    load_profile,
    resolve_device_class,
    save_profile,
)
