"""The paper's classical baselines (bag of words, L1-SVC feature selection,
RF, NB, MLP, LR, KNN) without scikit-learn; see :mod:`.sklearn_baseline`."""

from .sklearn_baseline import run_baselines  # noqa: F401
