"""Checker families of the static-analysis engine (the JAX package's
``analysis/checkers``).

Importing this package registers every checker with the engine's
registry (``engine.CHECKERS``); each module is one family:

* :mod:`.prints`    — MV101 bare print
* :mod:`.handlers`  — MV102 blocking in handler/router classes
* :mod:`.artifacts` — MV103 artifact-write hygiene
* :mod:`.purity`    — MV201 forward purity (host syncs in nn.Module code)
* :mod:`.locks`     — MV301/302/303 lock discipline in threaded classes
* :mod:`.drift`     — MV401–405 registry drift (faults / metrics /
  config / kernel-build chokepoint)
"""

from . import artifacts, drift, handlers, locks, prints, purity  # noqa: F401
