"""The paper's classical baselines without scikit-learn (the JAX package's
``baselines/sklearn_baseline.py``, which calls sklearn).

Reference (Baseline/baseline.py + dimension_reduce.py): bag-of-words
``CountVectorizer(stop_words="english")``, L1 ``LinearSVC(C=0.3,
dual=False)`` feature selection through ``SelectFromModel``, then five
learners, RandomForest (30 trees, OOB), MultinomialNB, MLP (``max_iter``
10), LogisticRegression and KNN, each writing ``{learner}_result.json`` and
``{learner}_metric.json`` with the measure dict of the neural paths.  The
port's stand-ins, each the same model as sklearn's:

* :class:`CountVectorizer` — the token pattern ``(?u)\\b\\w\\w+\\b`` over the
  lowercased text, the port's copy of sklearn's 318 English stop words, a
  sorted vocabulary; sparse CSR counts (scipy), never a dense matrix;
* :func:`l1_svc` — the squared-hinge L1 primal ``Σ|w| + C Σ max(0, 1 −
  y·(x·w + b))²`` (the bias a feature of value 1, penalised, as liblinear
  has it), solved on the device by coordinate-descent Newton steps taken
  for every feature at once with an Armijo line search; the features kept
  are those with ``|w| >= 1e-5``, sklearn's threshold for an L1 estimator;
* :class:`MultinomialNB` (alpha 1) and :class:`LogisticRegression` (L2,
  C 1, the intercept unpenalised, L-BFGS up to 1000 iterations) in f64 on
  the device;
* :class:`KNeighborsClassifier` — 5 neighbours, uniform votes, Euclidean
  distances in f64 tiles on the device, ties broken by the lower train
  index;
* :class:`MLPClassifier` — 100 ReLU units and a logistic output, sklearn's
  Glorot-uniform start, Adam at 1e-3, batches of ``min(200, n)``, L2 alpha
  1e-4, 10 epochs, its draws from a seeded ``torch.Generator``;
* :class:`RandomForestClassifier` — 30 gini trees grown to purity on
  bootstrap samples, ``√features`` candidates a split, the out-of-bag
  score; numpy on the host, as sklearn's is a host algorithm.

Each learner takes and returns host arrays (``fit``, ``predict``,
``predict_proba``) and computes on ``device``; RF and MLP draw other random
numbers than sklearn, so they match it in distribution, not bit for bit.
"""

from __future__ import annotations

import json
import logging
import math
import re
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..evaluate.metrics import model_measure
from .stop_words import ENGLISH_STOP_WORDS

logger = logging.getLogger(__name__)

TOKEN_PATTERN = re.compile(r"(?u)\b\w\w+\b")

# the reference's settings (Baseline/baseline.py, dimension_reduce.py) and
# sklearn's defaults for the rest
SVC_C = 0.3           # LinearSVC(penalty="l1", C=0.3, dual=False)
SVC_TOL = 1e-5        # the stop: optimality violation below this share of its value at 0
SVC_MAX_ITER = 10000
NB_ALPHA = 1.0
LR_C = 1.0
LR_MAX_ITER = 1000
KNN_K = 5
MLP_HIDDEN = 100
MLP_ALPHA = 1e-4
MLP_LR = 1e-3
MLP_EPOCHS = 10       # MLPClassifier(max_iter=10)
MLP_BATCH = 200
RF_TREES = 30


# -- bag of words ----------------------------------------------------------------


class CountVectorizer:
    """sklearn's ``CountVectorizer(stop_words="english")``: lowercase,
    tokenize with :data:`TOKEN_PATTERN`, drop the stop words, count.  The
    vocabulary (``vocabulary_``) is sorted, so feature ``j`` is the
    ``j``-th term in code-point order; counts are int64 CSR."""

    def __init__(self, stop_words: Iterable[str] = ENGLISH_STOP_WORDS) -> None:
        self.stop_words = frozenset(stop_words)
        self.vocabulary_: Dict[str, int] = {}

    def _tokens(self, doc: str) -> List[str]:
        return [t for t in TOKEN_PATTERN.findall(doc.lower()) if t not in self.stop_words]

    def _count(self, docs: Iterable[str], vocabulary: Dict[str, int], grow: bool):
        indptr, indices, values = [0], [], []
        for doc in docs:
            counts: Dict[int, int] = {}
            for tok in self._tokens(doc):
                j = vocabulary.get(tok)
                if j is None:
                    if not grow:
                        continue
                    j = vocabulary[tok] = len(vocabulary)
                counts[j] = counts.get(j, 0) + 1
            indices.extend(counts)
            values.extend(counts.values())
            indptr.append(len(indices))
        return (np.asarray(values, np.int64), np.asarray(indices, np.int64),
                np.asarray(indptr, np.int64))

    def fit_transform(self, docs: Sequence[str]) -> sp.csr_matrix:
        seen: Dict[str, int] = {}
        values, indices, indptr = self._count(docs, seen, grow=True)
        if not seen:
            raise ValueError("empty vocabulary; perhaps the documents only contain stop words")
        terms = sorted(seen)
        remap = np.empty(len(terms), np.int64)
        for new, term in enumerate(terms):
            remap[seen[term]] = new
        self.vocabulary_ = {term: i for i, term in enumerate(terms)}
        x = sp.csr_matrix((values, remap[indices], indptr), shape=(len(indptr) - 1, len(terms)))
        x.sort_indices()
        return x

    def transform(self, docs: Sequence[str]) -> sp.csr_matrix:
        values, indices, indptr = self._count(docs, self.vocabulary_, grow=False)
        x = sp.csr_matrix((values, indices, indptr),
                          shape=(len(indptr) - 1, len(self.vocabulary_)))
        x.sort_indices()
        return x


# -- device helpers ----------------------------------------------------------------


def _sparse(x: sp.spmatrix, device: torch.device) -> torch.Tensor:
    """A scipy matrix as an f64 ``torch.sparse_csr`` tensor on ``device``."""
    x = sp.csr_matrix(x, dtype=np.float64)
    return torch.sparse_csr_tensor(
        torch.from_numpy(x.indptr.astype(np.int64)), torch.from_numpy(x.indices.astype(np.int64)),
        torch.from_numpy(x.data), size=x.shape, dtype=torch.float64, device=device,
        check_invariants=False)


def _spmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sparse CSR matrix times a dense vector (SpMV)."""
    return a @ v


def _dense_rows(x: sp.spmatrix, start: int, stop: int, device: torch.device) -> torch.Tensor:
    """Rows ``start:stop`` of ``x`` as a dense f64 tile on ``device``."""
    return torch.from_numpy(sp.csr_matrix(x[start:stop], dtype=np.float64).toarray()).to(device)


def _signs(y: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(2.0 * np.asarray(y, np.float64) - 1.0).to(device)


# -- L1 linear SVC feature selection --------------------------------------------------


_ZERO = 1e-10  # |w| at or below it: a coordinate at 0


def l1_svc(
    x: sp.spmatrix, y: np.ndarray, device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, float]:
    """``LinearSVC(penalty="l1", loss="squared_hinge", C=SVC_C, dual=False)``:
    the minimiser of ``Σ|w_j| + |b| + C Σ_i max(0, 1 − y_i(x_i·w + b))²``
    (labels in {0, 1} as ∓1).  Each iteration takes, for every coordinate
    at once, the minimiser of its one-dimensional second-order model (the
    generalised Hessian's diagonal over the margin violators) and backs
    off along that direction until the Armijo condition holds; it stops
    when the summed optimality violation falls below ``SVC_TOL`` times its
    value at zero (or after ``SVC_MAX_ITER`` iterations); the coordinates
    within ``_ZERO`` of 0 end at exactly 0.  Returns (coef [F], intercept)
    on the host."""
    device = torch.device(device)
    c = SVC_C
    n, n_feat = x.shape
    aug = sp.hstack([sp.csr_matrix(x, dtype=np.float64), np.ones((n, 1))], format="csr")
    a = _sparse(aug, device)
    at = _sparse(aug.T.tocsr(), device)
    at_sq = _sparse(aug.multiply(aug).T.tocsr(), device)
    ys = _signs(y, device)
    w = torch.zeros(n_feat + 1, dtype=torch.float64, device=device)
    z = torch.zeros(n, dtype=torch.float64, device=device)  # aug @ w

    def objective(z, w):
        m = (1.0 - ys * z).clamp_min(0.0)
        return w.abs().sum() + c * (m * m).sum()

    f = objective(z, w)
    first_violation = None
    for it in range(SVC_MAX_ITER + 1):
        margin = 1.0 - ys * z
        active = (margin > 0).to(torch.float64)
        g = -2.0 * c * _spmv(at, ys * margin * active)
        h = 2.0 * c * _spmv(at_sq, active) + 1e-12
        # the optimality violation (the minimum-norm subgradient's size); a
        # coordinate headed for 0 shrinks by the step each iteration without
        # reaching it, so below _ZERO it counts as 0
        zero = w.abs() <= _ZERO
        violation = torch.where(
            zero, (g.abs() - 1).clamp_min(0.0),
            torch.where(w > 0, (g + 1).abs(), (g - 1).abs())).sum()
        if first_violation is None:
            first_violation = violation
        if it == SVC_MAX_ITER or float(violation) <= SVC_TOL * float(first_violation):
            break
        d = torch.where(g + 1 <= h * w, -(g + 1) / h,
                        torch.where(g - 1 >= h * w, -(g - 1) / h, -w))
        delta = (g * d).sum() + (w + d).abs().sum() - w.abs().sum()
        if float(delta) >= 0:
            break
        ad = _spmv(a, d)
        step = 1.0
        while True:
            trial = objective(z + step * ad, w + step * d)
            if float(trial - f) <= 0.01 * step * float(delta) or step < 1e-12:
                break
            step *= 0.5
        w = w + step * d
        z = z + step * ad
        f = trial
    w = torch.where(w.abs() <= _ZERO, torch.zeros_like(w), w)
    coef = w.cpu().numpy()
    return coef[:-1], float(coef[-1])


def select_features(coef: np.ndarray, threshold: float = 1e-5) -> np.ndarray:
    """``SelectFromModel``'s support for an L1 estimator: ``|coef| >= 1e-5``."""
    return np.abs(coef) >= threshold


# -- the learners ----------------------------------------------------------------------


class _Learner:
    """``fit(x, y)`` on a host CSR matrix and {0, 1} labels;
    ``predict_proba`` → [n, 2] host probabilities; ``predict`` their
    argmax."""

    def __init__(self, device: Union[str, torch.device] = "cuda") -> None:
        self.device = torch.device(device)

    def predict(self, x: sp.spmatrix) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)


class MultinomialNB(_Learner):
    """sklearn's ``MultinomialNB()`` (alpha ``NB_ALPHA``) in f64."""

    def fit(self, x: sp.spmatrix, y: np.ndarray) -> "MultinomialNB":
        y = np.asarray(y)
        onehot = torch.from_numpy(np.stack([y == 0, y == 1], axis=1).astype(np.float64))
        onehot = onehot.to(self.device)
        counts = _sparse(sp.csr_matrix(x).T.tocsr(), self.device) @ onehot  # [F, 2]
        smoothed = counts.T + NB_ALPHA
        self.feature_log_prob_ = smoothed.log() - smoothed.sum(dim=1, keepdim=True).log()
        class_count = onehot.sum(dim=0)
        self.class_log_prior_ = class_count.log() - class_count.sum().log()
        return self

    def predict_proba(self, x: sp.spmatrix) -> np.ndarray:
        jll = _sparse(x, self.device) @ self.feature_log_prob_.T.contiguous() + self.class_log_prior_
        return torch.softmax(jll, dim=1).cpu().numpy()


class LogisticRegression(_Learner):
    """sklearn's ``LogisticRegression(max_iter=1000)``: L2 with ``C`` 1, an
    unpenalised intercept, L-BFGS (strong Wolfe line search) in f64 up to
    ``LR_MAX_ITER`` iterations on ``(1/n)·Σ log(1 + exp(−y·(x·w + b))) +
    ‖w‖²/(2Cn)``."""

    def fit(self, x: sp.spmatrix, y: np.ndarray) -> "LogisticRegression":
        n, n_feat = x.shape
        a = _sparse(x, self.device)
        at = _sparse(sp.csr_matrix(x).T.tocsr(), self.device)
        ys = _signs(y, self.device)
        w = torch.zeros(n_feat, dtype=torch.float64, device=self.device, requires_grad=True)
        b = torch.zeros(1, dtype=torch.float64, device=self.device, requires_grad=True)
        reg = 1.0 / (LR_C * n)
        opt = torch.optim.LBFGS([w, b], lr=1.0, max_iter=LR_MAX_ITER, history_size=10,
                                tolerance_grad=1e-10, tolerance_change=1e-14,
                                line_search_fn="strong_wolfe")

        def closure():
            # the gradient by hand: autograd through a sparse product is not needed
            with torch.no_grad():
                margin = ys * (_spmv(a, w) + b)
                loss = F.softplus(-margin).mean() + 0.5 * reg * (w * w).sum()
                r = -ys * torch.sigmoid(-margin) / n
                w.grad = _spmv(at, r) + reg * w
                b.grad = r.sum().reshape(1)
            return loss

        opt.step(closure)
        self.coef_ = w.detach()
        self.intercept_ = b.detach()
        return self

    def decision_function(self, x: sp.spmatrix) -> np.ndarray:
        return (_spmv(_sparse(x, self.device), self.coef_) + self.intercept_).cpu().numpy()

    def predict_proba(self, x: sp.spmatrix) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-self.decision_function(x)))
        return np.stack([1.0 - p, p], axis=1)


class KNeighborsClassifier(_Learner):
    """sklearn's ``KNeighborsClassifier()``: the ``KNN_K`` nearest training
    rows by Euclidean distance (f64 ``tile`` × ``tile`` blocks of ``‖a‖² +
    ‖b‖² − 2a·b`` on the device), uniform votes; among equal distances the
    lower training index wins."""

    def __init__(self, tile: int = 4096, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        self.tile = int(tile)

    def fit(self, x: sp.spmatrix, y: np.ndarray) -> "KNeighborsClassifier":
        self.x_ = sp.csr_matrix(x, dtype=np.float64)
        self.y_ = torch.from_numpy(np.asarray(y, np.int64)).to(self.device)
        self.sq_ = torch.from_numpy(np.asarray(self.x_.multiply(self.x_).sum(axis=1)).ravel())
        self.sq_ = self.sq_.to(self.device)
        return self

    def kneighbors(self, x: sp.spmatrix) -> Tuple[np.ndarray, np.ndarray]:
        """(squared distances, training indices) of each row's neighbours,
        nearest first."""
        x = sp.csr_matrix(x, dtype=np.float64)
        n_train = self.x_.shape[0]
        k = min(KNN_K, n_train)
        dists, idxs = [], []
        for q0 in range(0, x.shape[0], self.tile):
            q = _dense_rows(x, q0, q0 + self.tile, self.device)
            q_sq = (q * q).sum(dim=1, keepdim=True)
            best_d = torch.full((q.shape[0], 0), 0.0, dtype=torch.float64, device=self.device)
            best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=self.device)
            for t0 in range(0, n_train, self.tile):
                t = _dense_rows(self.x_, t0, t0 + self.tile, self.device)
                d = (q_sq + self.sq_[t0 : t0 + t.shape[0]] - 2.0 * (q @ t.T)).clamp_min(0.0)
                ids = torch.arange(t0, t0 + t.shape[0], device=self.device).expand_as(d)
                # the kept neighbours come first and have lower indices, so a
                # stable sort breaks every tie towards the lower index
                cand_d = torch.cat([best_d, d], dim=1)
                cand_i = torch.cat([best_i, ids], dim=1)
                order = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
                best_d = cand_d.gather(1, order)
                best_i = cand_i.gather(1, order)
            dists.append(best_d.cpu().numpy())
            idxs.append(best_i.cpu().numpy())
        return np.concatenate(dists), np.concatenate(idxs)

    def predict_proba(self, x: sp.spmatrix) -> np.ndarray:
        _, idx = self.kneighbors(x)
        votes = self.y_[torch.from_numpy(idx).to(self.device)].to(torch.float64).mean(dim=1)
        p = votes.cpu().numpy()
        return np.stack([1.0 - p, p], axis=1)


class MLPClassifier(_Learner):
    """sklearn's ``MLPClassifier(max_iter=10)``: one hidden layer of 100
    ReLU units and a logistic output, weights and biases drawn
    U(±√(6/(fan_in + fan_out))), Adam (lr 1e-3, betas 0.9/0.999, eps 1e-8,
    sklearn's bias-corrected step) on minibatches of ``min(200, n)`` rows,
    reshuffled every epoch for 10 epochs, with the L2 term
    ``alpha·‖W‖²/(2·batch)``, alpha 1e-4; f64, on the device, every draw
    from a ``torch.Generator`` seeded ``seed``."""

    def __init__(self, seed: int = 2021, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        self.seed = int(seed)

    def _init(self, fan_in: int, fan_out: int, gen: torch.Generator):
        bound = math.sqrt(6.0 / (fan_in + fan_out))

        def draw(*shape):
            u = torch.rand(shape, generator=gen, dtype=torch.float64, device=self.device)
            return ((2.0 * u - 1.0) * bound).requires_grad_()

        return draw(fan_in, fan_out), draw(fan_out)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        (w1, b1), (w2, b2) = self.layers_
        return (torch.relu(x @ w1 + b1) @ w2 + b2).squeeze(1)

    def fit(self, x: sp.spmatrix, y: np.ndarray) -> "MLPClassifier":
        x = sp.csr_matrix(x, dtype=np.float64)
        n, n_feat = x.shape
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.layers_ = [self._init(n_feat, MLP_HIDDEN, gen), self._init(MLP_HIDDEN, 1, gen)]
        params = [p for layer in self.layers_ for p in layer]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        b1, b2, eps = 0.9, 0.999, 1e-8
        target = torch.from_numpy(np.asarray(y, np.float64)).to(self.device)
        batch = min(MLP_BATCH, n)
        t = 0
        for _ in range(MLP_EPOCHS):
            order = torch.randperm(n, generator=gen, device=self.device).cpu().numpy()
            for s in range(0, n, batch):
                rows = order[s : s + batch]
                xb = torch.from_numpy(x[rows].toarray()).to(self.device)
                loss = F.binary_cross_entropy_with_logits(self._forward(xb), target[rows])
                weights = self.layers_[0][0].pow(2).sum() + self.layers_[1][0].pow(2).sum()
                loss = loss + 0.5 * MLP_ALPHA * weights / len(rows)
                grads = torch.autograd.grad(loss, params)
                t += 1
                step = MLP_LR * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
                with torch.no_grad():
                    for p, g, mi, vi in zip(params, grads, m, v):
                        mi.mul_(b1).add_(g, alpha=1.0 - b1)
                        vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                        p.sub_(step * mi / (vi.sqrt() + eps))
        return self

    @torch.no_grad()
    def predict_proba(self, x: sp.spmatrix) -> np.ndarray:
        x = sp.csr_matrix(x, dtype=np.float64)
        out = []
        for s in range(0, x.shape[0], 4096):
            out.append(torch.sigmoid(self._forward(_dense_rows(x, s, s + 4096, self.device))))
        p = torch.cat(out).cpu().numpy()
        return np.stack([1.0 - p, p], axis=1)


class _Tree:
    """One fully grown gini tree: parallel arrays over nodes (a leaf has
    feature -1) and each node's class fractions."""

    def __init__(self) -> None:
        self.feature: List[int] = []
        self.threshold: List[float] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.value: List[np.ndarray] = []

    def add(self, counts: np.ndarray) -> int:
        self.feature.append(-1)
        self.threshold.append(0.0)
        self.left.append(-1)
        self.right.append(-1)
        self.value.append(counts / counts.sum())
        return len(self.feature) - 1

    def freeze(self) -> None:
        self.feature_a = np.asarray(self.feature, np.int64)
        self.threshold_a = np.asarray(self.threshold)
        self.children = np.asarray([self.left, self.right], np.int64)
        self.value_a = np.asarray(self.value)

    def predict_proba(self, x: sp.csr_matrix) -> np.ndarray:
        node = np.zeros(x.shape[0], np.int64)
        rows = np.arange(x.shape[0])
        while True:
            inner = self.feature_a[node] >= 0
            if not inner.any():
                return self.value_a[node]
            r = rows[inner]
            vals = np.asarray(x[r, self.feature_a[node[r]]]).ravel()
            go_right = vals > self.threshold_a[node[r]]
            node[r] = self.children[go_right.astype(np.int64), node[r]]


def _best_split(block: np.ndarray, y: np.ndarray, w: np.ndarray):
    """The best gini split of ``block`` [rows, features] (rows weighted by
    ``w``, labels ``y``): (column, threshold, improvement proxy) or None
    when every column is constant.  Maximises ``Σ_k l_k²/l + Σ_k r_k²/r``
    over the class weights ``l``, ``r`` of the two sides."""
    order = np.argsort(block, axis=0, kind="stable")
    vals = np.take_along_axis(block, order, axis=0)
    wy = np.stack([w * (y == 0), w * (y == 1)], axis=-1)[order]  # [rows, feats, 2]
    left = np.cumsum(wy, axis=0)[:-1]
    right = wy.sum(axis=0) - left
    lw, rw = left.sum(-1), right.sum(-1)
    valid = (vals[1:] > vals[:-1]) & (lw > 0) & (rw > 0)
    if not valid.any():
        return None
    with np.errstate(divide="ignore", invalid="ignore"):
        score = (left ** 2).sum(-1) / lw + (right ** 2).sum(-1) / rw
    score = np.where(valid, score, -np.inf)
    pos, col = np.unravel_index(int(np.argmax(score)), score.shape)
    return col, 0.5 * (vals[pos, col] + vals[pos + 1, col]), score[pos, col]


_DENSE_NODE = 1 << 20  # cells: a node this small is split on a dense copy


def _grow_tree(x: sp.csr_matrix, y: np.ndarray, w: np.ndarray, mtry: int,
               rng: np.random.Generator) -> _Tree:
    """Grow a tree to purity on the rows with weight > 0 (bootstrap
    counts): each split evaluates ``mtry`` random features, and more if
    those are all constant in the node, as sklearn does."""
    tree = _Tree()
    n_feat = x.shape[1]

    def counts_of(rows):
        return np.array([w[rows][y[rows] == 0].sum(), w[rows][y[rows] == 1].sum()])

    root_rows = np.flatnonzero(w > 0)
    stack = [(root_rows, None, tree.add(counts_of(root_rows)))]
    while stack:
        rows, dense, node = stack.pop()
        counts = counts_of(rows)
        if len(rows) < 2 or counts.min() == 0:
            continue
        # a node this small is split on a dense copy of its rows, which its
        # children slice: their column reads are numpy's, not scipy's
        sub = None
        if dense is None:
            sub = x[rows]
            if len(rows) * n_feat <= _DENSE_NODE:
                dense = sub.toarray()

        def columns(feats):
            return dense[:, feats] if dense is not None else sub[:, feats].toarray()

        perm = rng.permutation(n_feat)
        best = None
        for start in range(0, n_feat, mtry):
            feats = perm[start : start + mtry]
            found = _best_split(columns(feats), y[rows], w[rows])
            if found is not None and (best is None or found[2] > best[2]):
                best = (feats[found[0]], found[1], found[2])
            if best is not None:
                break
        if best is None:
            continue
        feat, thr, _ = best
        go_left = columns([feat]).ravel() <= thr
        tree.feature[node], tree.threshold[node] = int(feat), float(thr)
        tree.left[node] = tree.add(counts_of(rows[go_left]))
        tree.right[node] = tree.add(counts_of(rows[~go_left]))
        for side, node_id in ((~go_left, tree.right[node]), (go_left, tree.left[node])):
            stack.append((rows[side], None if dense is None else dense[side], node_id))
    tree.freeze()
    return tree


class RandomForestClassifier(_Learner):
    """sklearn's ``RandomForestClassifier(n_estimators=30, oob_score=True)``
    on the host: each tree grown to purity on a bootstrap sample (as row
    weights), ``max(1, int(√F))`` candidate features a split; probabilities
    are the trees' mean leaf class fractions; ``oob_score_`` the accuracy
    of the out-of-bag votes."""

    def __init__(self, seed: int = 2021) -> None:
        super().__init__("cpu")
        self.seed = int(seed)

    def fit(self, x: sp.spmatrix, y: np.ndarray) -> "RandomForestClassifier":
        x = sp.csr_matrix(x, dtype=np.float64)
        y = np.asarray(y, np.int64)
        n, n_feat = x.shape
        mtry = max(1, int(np.sqrt(n_feat)))
        rng = np.random.default_rng(self.seed)
        self.trees_: List[_Tree] = []
        oob = np.zeros((n, 2))
        for _ in range(RF_TREES):
            w = np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
            tree = _grow_tree(x, y, w, mtry, rng)
            self.trees_.append(tree)
            out = np.flatnonzero(w == 0)
            if len(out):
                oob[out] += tree.predict_proba(x[out])
        voted = oob.sum(axis=1) > 0
        self.oob_score_ = float((oob[voted].argmax(axis=1) == y[voted]).mean()) if voted.any() \
            else float("nan")
        return self

    def predict_proba(self, x: sp.spmatrix) -> np.ndarray:
        x = sp.csr_matrix(x, dtype=np.float64)
        return sum(t.predict_proba(x) for t in self.trees_) / len(self.trees_)


# -- the run -----------------------------------------------------------------------


def _texts_and_labels(samples: Sequence[Dict], target: str) -> Tuple[List[str], np.ndarray]:
    texts, labels = [], []
    for s in samples:
        texts.append(f"{s.get('Issue_Title') or ''}. {s.get('Issue_Body') or ''}")
        labels.append(1 if str(s.get(target)) in ("1", "1.0", "pos") else 0)
    return texts, np.asarray(labels)


def default_learners(
    seed: int = 2021, device: Union[str, torch.device] = "cuda",
) -> Dict[str, _Learner]:
    return {
        "RF": RandomForestClassifier(seed=seed),
        "NB": MultinomialNB(device=device),
        "MLP": MLPClassifier(seed=seed, device=device),
        "LR": LogisticRegression(device=device),
        "KNN": KNeighborsClassifier(device=device),
    }


def run_baselines(
    train_path: Union[str, Path],
    test_path: Union[str, Path],
    out_dir: Union[str, Path],
    target: str = "Security_Issue_Full",
    learners: Optional[Dict[str, _Learner]] = None,
    feature_selection: bool = True,
    seed: int = 2021,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Vectorize both corpora, select features with the L1 SVC (unless
    ``feature_selection`` is off, or it keeps none), fit each learner and
    write ``{name}_result.json`` (per report: ``Issue_Url``, ``label``,
    ``predict``, ``prob``) and ``{name}_metric.json`` into ``out_dir``.
    Returns each learner's measure dict.  The device work runs on
    ``device`` (the card unless the caller asks for the CPU); each learner's
    seconds and the selected feature count are logged."""
    from ..build import resolve_device

    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    train = json.loads(Path(train_path).read_text())
    test = json.loads(Path(test_path).read_text())
    train_texts, y_train = _texts_and_labels(train, target)
    test_texts, y_test = _texts_and_labels(test, target)
    test_ids = [s.get("Issue_Url") for s in test]

    vectorizer = CountVectorizer()
    x_train = vectorizer.fit_transform(train_texts)
    x_test = vectorizer.transform(test_texts)
    if feature_selection and x_train.shape[1] > 1:
        t0 = time.perf_counter()
        coef, _ = l1_svc(x_train, y_train, device=device)
        support = select_features(coef)
        logger.info("L1-SVC selection: %d of %d features in %.3f s", int(support.sum()),
                    len(support), time.perf_counter() - t0)
        if int(support.sum()) > 0:
            x_train, x_test = x_train[:, support], x_test[:, support]
    logger.info("feature matrix: %s", x_train.shape)

    results: Dict[str, Dict[str, float]] = {}
    for name, learner in (learners or default_learners(seed, device)).items():
        t0 = time.perf_counter()
        learner.fit(x_train, y_train)
        proba = learner.predict_proba(x_test)
        seconds = time.perf_counter() - t0
        preds = proba.argmax(axis=1)
        scores = proba[:, 1]
        measured = model_measure(y_test, preds, scores)
        results[name] = measured
        records = [
            {
                "Issue_Url": test_ids[i],
                "label": "pos" if y_test[i] else "neg",
                "predict": "pos" if preds[i] else "neg",
                "prob": float(scores[i]),
            }
            for i in range(len(y_test))
        ]
        (out_dir / f"{name}_result.json").write_text(json.dumps(records))
        (out_dir / f"{name}_metric.json").write_text(json.dumps(measured, indent=4))
        logger.info("learner %s: %s", name, json.dumps(
            {"seconds": seconds, "f1": measured["f1"], "auc": measured["auc"],
             "features": x_train.shape[1]}))
    return results
