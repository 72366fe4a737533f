"""The one general traffic generator: every mix under ``benchmark/traffic/``
is a file of parameters that this module reads.

* :func:`build_vocab` — a BERT-shaped vocabulary of any size from a seed:
  ``[PAD]``, ``[unused*]``, ``[UNK]``, ``[CLS]``, ``[SEP]``, ``[MASK]`` at
  bert-base-uncased's ids, the lowercase ASCII characters and their ``##``
  forms, then random ``##`` sub-words and random whole words;
* :func:`sentence_pool` — sentences of Zipf-distributed whole words, words
  with a sub-word glued on (the tokenizer cuts them), numbers and
  punctuation, each with its word and wordpiece counts;
* :class:`Corpus` — distinct reports assembled from the pool under the
  mix's length law, each opened by two words that encode its index, so no
  two reports of a run are alike; made :data:`CHUNK` reports at a time as a
  reader asks for them, so a stream never runs dry and set-up makes only the
  first chunk; lengths are drawn stratified in blocks, so every stretch of
  the stream follows the law closely and two seeds give the same sizes in
  another order; :func:`corpus` is its first ``n`` reports;
* :func:`anchors` — the anchor bank's texts;
* :func:`arrival_offsets` — open-loop arrival schedules for serving mixes,
  a frozen copy of the program's load generator's arrival code.

The length laws: ``lognormal_words`` is the realistic law of the program's
synthetic corpus (``int(lognormvariate(mu, sigma))`` words, clamped, whole
sentences added until the count is reached); ``loguniform_wordpieces`` draws
a wordpiece count log-uniformly between ``min`` and ``max`` and adds whole
sentences until the framed report has at least that many.
"""

from __future__ import annotations

import bisect
import math
import random
import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..reference.wordpiece import WordPiece

SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
FIRST_FREE_ID = 999  # bert-base-uncased's first character entry
_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
_PUNCT_INNER = [",", ",", ",", ":", ";", "(", ")", "=", "/", "-", "'", "\"", "[", "]", "<", ">"]
STRATA = 64  # lengths are stratified over blocks of this many reports
CHUNK = 16 * STRATA  # a corpus is made this many reports at a time


def seed_of(*parts: int) -> int:
    """A 64-bit seed derived from ``parts`` (the run seed and a stream tag)."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0])


def _random_words(rng: np.random.Generator, n: int, lo: int, hi: int) -> List[str]:
    lengths = rng.integers(lo, hi + 1, size=n)
    letters = _LETTERS[rng.integers(0, 26, size=(n, hi))]
    return ["".join(row[:k]) for row, k in zip(letters, lengths)]


def build_vocab(size: int, seed: int) -> List[str]:
    """``size`` distinct tokens in id order: a sixth of the free ids are
    ``##`` sub-words of 2-4 letters, the rest whole words of 2-10."""
    vocab = ["[unused%d]" % i for i in range(FIRST_FREE_ID)]
    for i, tok in SPECIALS.items():
        vocab[i] = tok
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    vocab += chars + ["##" + c for c in chars if c.isalnum()]
    free = size - len(vocab)
    if free < 64:
        raise ValueError(f"a vocabulary needs more than {len(vocab) + 64} entries, got {size}")
    rng = np.random.default_rng(seed_of(seed, 1))
    seen = set(vocab)

    def fresh(count: int, lo: int, hi: int, prefix: str) -> List[str]:
        out: List[str] = []
        while len(out) < count:
            for w in _random_words(rng, 2 * (count - len(out)), lo, hi):
                tok = prefix + w
                if tok not in seen and len(out) < count:
                    seen.add(tok)
                    out.append(tok)
        return out

    subs = fresh(free // 6, 2, 4, "##")
    return vocab + subs + fresh(free - len(subs), 2, 10, "")


def whole_words(vocab: Sequence[str]) -> List[str]:
    """The vocabulary's random whole words (two letters or more), in id order."""
    return [t for t in vocab[FIRST_FREE_ID:] if len(t) > 1 and t.isalpha()]


def sentence_pool(vocab: Sequence[str], params: Dict, seed: int, tokenizer: WordPiece) -> Dict:
    """``params``: ``sentences`` (pool size), ``words`` ([min, max] per
    sentence), ``zipf`` (exponent over the whole words), ``compound`` (share
    of words with a sub-word glued on), ``number`` (share of numbers),
    ``punct`` (share of words followed by inner punctuation), ``end``
    (share of sentences closed by a full stop or a question mark).  Returns
    the texts with their word and wordpiece counts."""
    rng = np.random.default_rng(seed_of(seed, 2))
    words = whole_words(vocab)
    subs = [t[2:] for t in vocab[FIRST_FREE_ID:] if t.startswith("##") and len(t) > 3]
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    p = ranks ** -float(params["zipf"])
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    lo, hi = params["words"]
    texts, n_words, n_pieces = [], [], []
    for _ in range(int(params["sentences"])):
        k = int(rng.integers(lo, hi + 1))
        picks = np.searchsorted(cdf, rng.random(k), side="right")
        kinds = rng.random((k, 3))
        out = []
        for j, w in enumerate(picks):
            tok = words[w]
            if kinds[j, 0] < params["number"]:
                tok = str(int(rng.integers(0, 100000)))
            elif kinds[j, 0] < params["number"] + params["compound"] and subs:
                tok += subs[int(rng.integers(0, len(subs)))]
            if j == 0:
                tok = tok.capitalize()
            if kinds[j, 1] < params["punct"] and j < k - 1:
                tok += _PUNCT_INNER[int(rng.integers(0, len(_PUNCT_INNER)))]
            out.append(tok)
        text = " ".join(out)
        if kinds[0, 2] < params["end"]:
            text += "." if kinds[0, 2] < 0.8 * params["end"] else "?"
        texts.append(text)
        n_words.append(len(text.split()))
        n_pieces.append(len(tokenizer.pieces(text)))
    return {"texts": np.array(texts, dtype=object), "words": np.array(n_words),
            "pieces": np.array(n_pieces)}


_PROBIT = None


def _probit(u: np.ndarray) -> np.ndarray:
    """The standard normal quantile, interpolated on a fixed grid (the same
    numbers on every machine)."""
    global _PROBIT
    if _PROBIT is None:
        grid = np.linspace(0.0, 1.0, 8193)[1:-1]
        nd = statistics.NormalDist()
        _PROBIT = (grid, np.array([nd.inv_cdf(float(x)) for x in grid]))
    grid, values = _PROBIT
    return np.interp(u, grid, values)


def stratified_uniforms(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` uniforms, each block of :data:`STRATA` holding one draw from
    each of its strata, in random order."""
    blocks = -(-n // STRATA)
    order = np.argsort(rng.random((blocks, STRATA)), axis=1)
    return ((order + rng.random((blocks, STRATA))) / STRATA).reshape(-1)[:n]


def draw_lengths(law: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    u = stratified_uniforms(n, rng)
    if law["law"] == "lognormal_words":
        z = _probit(np.clip(u, 1e-9, 1 - 1e-9))
        target = np.floor(np.exp(law["mu"] + law["sigma"] * z))
    elif law["law"] == "loguniform_wordpieces":
        target = np.floor(law["min"] * (law["max"] / law["min"]) ** u)
    else:
        raise ValueError(f"unknown length law {law['law']!r}")
    return np.clip(target, law.get("clamp_min", 1), law.get("clamp_max", 1 << 30)).astype(np.int64)


def _unit(law: Dict) -> str:
    return "words" if law["law"].endswith("_words") else "pieces"


def _assemble(pool: Dict, targets: np.ndarray, unit: str, overhead: int,
              rng: np.random.Generator) -> Tuple[List[str], np.ndarray]:
    """For each target, the pool sentences (a run of one random stream)
    that bring the count to it, joined, and their wordpieces; ``overhead``
    counts what every text has besides its sentences."""
    counts = pool[unit]
    need = np.maximum(targets - overhead, 1)
    size = int(need.sum() / counts.mean() * 1.25) + 64
    stream = rng.integers(0, len(counts), size=size)
    while True:
        cum = np.concatenate([[0], np.cumsum(counts[stream])])
        if cum[-1] >= need.sum() + counts.max() * len(need) or len(stream) > 8 * size:
            break
        stream = np.concatenate([stream, rng.integers(0, len(counts), size=size)])
    cum_list, stream_list = cum.tolist(), stream.tolist()
    pieces = np.concatenate([[0], np.cumsum(pool["pieces"][stream])])
    texts = pool["texts"].tolist()
    out, bounds, pos = [], [0], 0
    for want in need.tolist():
        end = bisect.bisect_left(cum_list, cum_list[pos] + want, pos)
        if end >= len(cum_list):
            raise RuntimeError("the sentence stream is too short for the targets")
        out.append(" ".join([texts[j] for j in stream_list[pos:end]]))
        bounds.append(end)
        pos = end
    bounds = np.array(bounds)
    return out, pieces[bounds[1:]] - pieces[bounds[:-1]]


class Corpus:
    """The reports of one run under ``mix["lengths"]``, made a chunk at a
    time: chunk ``k`` comes from its own stream of the seed, so report ``i``
    is the same however far a run reads.  :meth:`text` makes chunks up to
    the one asked for; the wordpieces counted include the ``[CLS]`` and
    ``[SEP]`` framing, before any truncation."""

    def __init__(self, mix: Dict, pool: Dict, vocab: Sequence[str], seed: int) -> None:
        self.law, self.pool, self.seed = mix["lengths"], pool, seed
        self.unit = _unit(self.law)
        self.words = whole_words(vocab)
        self.texts: List[str] = []
        self._pieces: List[np.ndarray] = []

    def __len__(self) -> int:
        return len(self.texts)

    def _extend(self) -> None:
        start, w = len(self.texts), len(self.words)
        if start + CHUNK > w * w:
            raise ValueError(f"{start + CHUNK} reports exceed the {w * w} distinct openings")
        rng = np.random.default_rng(seed_of(self.seed, 3, start // CHUNK))
        # the opening: two whole words (one piece each), then the sentences;
        # a wordpiece count also counts the [CLS] and [SEP] framing
        overhead = 2 if self.unit == "words" else 4
        bodies, pieces = _assemble(self.pool, draw_lengths(self.law, CHUNK, rng), self.unit,
                                   overhead, rng)
        words = self.words
        self.texts.extend(f"{words[i % w]} {words[i // w]} {body}"
                          for i, body in enumerate(bodies, start))
        self._pieces.append(pieces + 4)

    def text(self, i: int) -> str:
        while i >= len(self.texts):
            self._extend()
        return self.texts[i]

    def pieces(self) -> np.ndarray:
        """The wordpieces of every report made so far."""
        return np.concatenate(self._pieces) if self._pieces else np.zeros(0, np.int64)


def corpus(mix: Dict, n: int, pool: Dict, vocab: Sequence[str],
           seed: int) -> Tuple[List[str], np.ndarray]:
    """The first ``n`` reports of the run's :class:`Corpus` and their
    wordpieces."""
    c = Corpus(mix, pool, vocab, seed)
    if n:
        c.text(n - 1)
    return c.texts[:n], c.pieces()[:n]


def anchors(spec: Dict, pool: Dict, vocab: Sequence[str], seed: int) -> List[Dict]:
    """The bank's ``spec["count"]`` anchors as scoring instances (``text1``,
    ``meta.label``), lengths from ``spec["lengths"]``."""
    rng = np.random.default_rng(seed_of(seed, 4))
    law = spec["lengths"]
    targets = draw_lengths(law, int(spec["count"]), rng)
    bodies, _ = _assemble(pool, targets, _unit(law), 2, rng)
    words = whole_words(vocab)
    return [{"text1": f"{words[k]} weakness {body}", "label": "same",
             "meta": {"label": f"CWE-{k + 1}"}} for k, body in enumerate(bodies)]


# -- arrivals for serving mixes (not used by a corpus mix yet) ------------------

def arrival_offsets(pattern: str, n: int, rps: float, seed: int, burst_size: int = 32,
                    burst_idle_s: float = 0.05, diurnal_period_s: float = 2.0,
                    diurnal_floor: float = 0.25) -> List[float]:
    """Submission times in seconds from load start, deterministic in the
    arguments: ``closed`` (no schedule), ``burst``, ``diurnal`` or a Poisson
    process (``poisson``)."""
    rng = random.Random(seed)
    if pattern == "closed":
        return [0.0] * n
    if pattern == "burst":
        offsets: List[float] = []
        t = 0.0
        while len(offsets) < n:
            offsets.extend([t] * min(burst_size, n - len(offsets)))
            t += burst_idle_s
        return offsets
    offsets, t = [], 0.0
    if pattern == "diurnal":
        floor = max(0.0, min(1.0, diurnal_floor))
        for _ in range(n):
            phase = 2.0 * math.pi * (t / diurnal_period_s)
            scale = floor + (1.0 - floor) * 0.5 * (1.0 - math.cos(phase))
            t += rng.expovariate(1.0) / max(rps * scale, 1e-6)
            offsets.append(t)
        return offsets
    if pattern != "poisson":
        raise ValueError(f"unknown arrival pattern {pattern!r}")
    for _ in range(n):
        t += rng.expovariate(max(rps, 1e-6))
        offsets.append(t)
    return offsets
