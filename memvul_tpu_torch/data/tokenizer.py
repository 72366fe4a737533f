"""Offline BERT WordPiece tokenization in plain Python.

The JAX package tokenizes through the ``tokenizers`` library
(``memvul_tpu/data/tokenizer.py``); the port does the same job without
it, id for id:

* **BertNormalizer**: drop NUL, U+FFFD and control characters (Unicode
  ``Cc``/``Cf``/``Co``/``Cs`` except tab, newline and carriage
  return), map whitespace to a space, put spaces around CJK ideographs,
  apply NFD and drop non-spacing marks when stripping accents (on by
  default with lowercasing), then lowercase character by character;
* **BertPreTokenizer**: split on whitespace, then isolate every
  punctuation character (Unicode ``P*`` plus ASCII 33-47, 58-64, 91-96
  and 123-126);
* **added tokens** from a tokenizer.json: matched literally in the raw
  text before normalisation (leftmost-longest), as ``tokenizers`` does;
* **WordPiece**: greedy longest match first with the ``##`` prefix and
  ``max_input_chars_per_word`` (100); a word that cannot be decomposed
  becomes ``[UNK]``;
* **framing**: ``[CLS] … [SEP]``, and truncation that keeps ``[SEP]``.

Character classes come from Python's ``unicodedata``.  The ``tokenizers``
library carries older Unicode tables, so about 600 of the 1.1M code
points (characters assigned in recent Unicode versions, in rare scripts)
are classed differently; every other code point normalises and splits
the same way.

A vocabulary comes from a bert-style ``vocab.txt`` (which wins when both
are given and it exists), a tokenizer.json whose model is WordPiece, or
:meth:`WordPieceTokenizer.build_deterministic`.

:class:`WordTokenizer` is the TextCNN baseline's word-level tokenizer,
its vocabulary a JSON ``{word: id}`` built from the training corpus.
"""

from __future__ import annotations

import json
import logging
import re
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from ..registry import Registrable

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = [PAD, UNK, CLS, SEP, MASK]

# placeholder tags produced by the data layer's normalizer — kept as tokens
_TAG_TOKENS = [
    "APITAG", "CODETAG", "ERRORTAG", "FILETAG", "URLTAG", "CVETAG",
    "EMAILTAG", "MENTIONTAG", "PATHTAG", "NUMBERTAG",
]

# Unicode White_Space (what ``char::is_whitespace`` tests in tokenizers)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B))
)
_CONTROL_CATEGORIES = frozenset({"Cc", "Cf", "Co", "Cs"})
# ASCII fast path (same results as the per-character walk): control
# characters drop except tab, newline and CR, which become spaces; ASCII
# has no CJK, no accents to strip and no multi-character lowercase
_ASCII_CLEAN = {c: None for c in [*range(32), 127]}
_ASCII_CLEAN.update({9: " ", 10: " ", 13: " "})
_ASCII_PUNCT = r"!-/:-@\[-`{-~"
_ASCII_WORDS = re.compile(rf"[^ \t\n\x0b\x0c\r{_ASCII_PUNCT}]+|[{_ASCII_PUNCT}]")
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch) in _CONTROL_CATEGORIES


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class BertNormalizer:
    def __init__(
        self,
        clean_text: bool = True,
        handle_chinese_chars: bool = True,
        strip_accents: Optional[bool] = None,
        lowercase: bool = True,
    ) -> None:
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.lowercase = lowercase

    def __call__(self, text: str) -> str:
        if text.isascii():
            if self.clean_text:
                text = text.translate(_ASCII_CLEAN)
            return text.lower() if self.lowercase else text
        out = []
        for ch in text:
            if self.clean_text:
                if ch in ("\x00", "\ufffd") or _is_control(ch):
                    continue
                if ch in _WHITESPACE:
                    ch = " "
            if self.handle_chinese_chars and _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(
                c for c in unicodedata.normalize("NFD", text)
                if unicodedata.category(c) != "Mn"
            )
        if self.lowercase:
            # per character, as tokenizers does (no final-sigma context rule)
            text = "".join(c.lower() for c in text)
        return text


def bert_pre_tokenize(text: str) -> List[str]:
    """Whitespace split, then each punctuation character on its own."""
    if text.isascii():
        return _ASCII_WORDS.findall(text)
    words: List[str] = []
    current: List[str] = []
    for ch in text:
        if ch in _WHITESPACE:
            if current:
                words.append("".join(current))
                current = []
        elif _is_punctuation(ch):
            if current:
                words.append("".join(current))
                current = []
            words.append(ch)
        else:
            current.append(ch)
    if current:
        words.append("".join(current))
    return words


class TextTokenizer(Registrable):
    """Base of the registered tokenizers (``tokenizer.type`` in a config):
    "wordpiece" (the default) and "word"."""

    default_implementation = "wordpiece"


@TextTokenizer.register("wordpiece")
class WordPieceTokenizer(TextTokenizer):
    """BERT-style wordpiece tokenizer, the port's counterpart of
    ``memvul_tpu.data.tokenizer.WordPieceTokenizer``."""

    def __init__(
        self,
        vocab_path: Optional[Union[str, Path]] = None,
        tokenizer_path: Optional[Union[str, Path]] = None,
        lowercase: bool = True,
    ) -> None:
        if vocab_path is not None and Path(vocab_path).exists():
            self._init_vocab(_read_vocab(str(vocab_path)), lowercase)
        elif tokenizer_path is not None:
            if vocab_path is not None:
                logging.getLogger(__name__).warning(
                    "tokenizer: config names vocab_path=%s but that file does "
                    "not exist — using the tokenizer file %s instead; its "
                    "tokenization will not match bert-base-uncased",
                    vocab_path, tokenizer_path,
                )
            self._init_file(Path(tokenizer_path))
        elif vocab_path is not None:
            self._init_vocab(_read_vocab(str(vocab_path)), lowercase)
        else:
            raise ValueError("need vocab_path or tokenizer_path")

    # -- construction ---------------------------------------------------------

    def _init_vocab(self, vocab: Dict[str, int], lowercase: bool) -> None:
        self._vocab = dict(vocab)
        self._normalizer = BertNormalizer(lowercase=lowercase)
        self._unk_token = UNK
        self._prefix = "##"
        self._max_chars = 100
        self._added: List[Tuple[str, int, bool]] = []
        self._always_frame = True
        self._finish()

    def _init_file(self, path: Path) -> None:
        spec = json.loads(path.read_text(encoding="utf-8"))
        model = spec.get("model") or {}
        if model.get("type") != "WordPiece":
            raise ValueError(
                f"{path}: tokenizer model {model.get('type')!r} is not WordPiece"
            )
        norm = spec.get("normalizer")
        if norm is None or norm.get("type") != "BertNormalizer":
            raise ValueError(f"{path}: normalizer {norm!r} is not a BertNormalizer")
        pre = spec.get("pre_tokenizer")
        if pre is None or pre.get("type") != "BertPreTokenizer":
            raise ValueError(f"{path}: pre-tokenizer {pre!r} is not BertPreTokenizer")
        self._vocab = dict(model["vocab"])
        self._normalizer = BertNormalizer(
            clean_text=norm.get("clean_text", True),
            handle_chinese_chars=norm.get("handle_chinese_chars", True),
            strip_accents=norm.get("strip_accents"),
            lowercase=norm.get("lowercase", True),
        )
        self._unk_token = model.get("unk_token", UNK)
        self._prefix = model.get("continuing_subword_prefix", "##")
        self._max_chars = int(model.get("max_input_chars_per_word", 100))
        self._added = [
            (t["content"], int(t["id"]), bool(t.get("normalized", False)))
            for t in spec.get("added_tokens") or []
        ]
        self._always_frame = spec.get("post_processor") is not None
        self._finish()

    def _finish(self) -> None:
        if self._unk_token not in self._vocab:
            raise ValueError(f"unk token {self._unk_token!r} not in the vocabulary")
        self._unk_id = self._vocab[self._unk_token]
        raw = [(c, i) for c, i, normalized in self._added if not normalized]
        norm = [(self._normalizer(c), i) for c, i, normalized in self._added if normalized]
        self._raw_added = _matcher(raw)
        self._norm_added = _matcher(norm)
        self._added_ids = {c: i for c, i, _ in self._added}
        self._cls = self.token_to_id(CLS)
        self._sep = self.token_to_id(SEP)
        self._pad = self.token_to_id(PAD)
        self._word_cache: Dict[str, List[int]] = {}

    @classmethod
    def from_vocab(cls, vocab: Dict[str, int], lowercase: bool = True) -> "WordPieceTokenizer":
        self = cls.__new__(cls)
        self._init_vocab(vocab, lowercase)
        return self

    @classmethod
    def build_deterministic(
        cls,
        texts: Iterable[str],
        vocab_size: int = 8192,
        save_path: Optional[Union[str, Path]] = None,
        lowercase: bool = True,
    ) -> "WordPieceTokenizer":
        """Deterministic vocabulary with exact tie-breaking: specials + tag
        tokens + every seen character (and its ``##`` form) + whole words
        ranked by (count desc, token asc), all counted through the same
        normalizer and pre-tokenizer the runtime uses.  Gives the JAX
        package's ``build_deterministic`` vocabulary id for id."""
        norm = BertNormalizer(lowercase=lowercase)
        counts: Counter = Counter()
        for text in texts:
            counts.update(bert_pre_tokenize(norm(text)))
        vocab: Dict[str, int] = {}
        tags = [t.lower() for t in _TAG_TOKENS] if lowercase else _TAG_TOKENS
        for tok in SPECIAL_TOKENS + tags:
            vocab.setdefault(tok, len(vocab))
        chars = sorted({c for w in counts for c in w})
        for c in chars:
            vocab.setdefault(c, len(vocab))
        for c in chars:
            vocab.setdefault(f"##{c}", len(vocab))
        for word, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if len(vocab) >= vocab_size:
                break
            vocab.setdefault(word, len(vocab))
        self = cls.from_vocab(vocab, lowercase)
        if save_path is not None:
            Path(save_path).parent.mkdir(parents=True, exist_ok=True)
            self.save(save_path)
        return self

    # -- encoding -------------------------------------------------------------

    def _wordpiece(self, word: str) -> List[int]:
        ids = self._word_cache.get(word)
        if ids is not None:
            return ids
        if len(word) > self._max_chars:
            ids = [self._unk_id]
        else:
            ids = []
            start = 0
            while start < len(word):
                end = len(word)
                found = None
                while start < end:
                    piece = word[start:end]
                    if start > 0:
                        piece = self._prefix + piece
                    found = self._vocab.get(piece)
                    if found is not None:
                        break
                    end -= 1
                if found is None:
                    ids = [self._unk_id]
                    break
                ids.append(found)
                start = end
        if len(self._word_cache) < 500_000:
            self._word_cache[word] = ids
        return ids

    def _model_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for segment, added in _split(text, self._raw_added):
            if added is not None:
                ids.append(added)
                continue
            for piece, added in _split(self._normalizer(segment), self._norm_added):
                if added is not None:
                    ids.append(added)
                    continue
                for word in bert_pre_tokenize(piece):
                    ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = self._model_ids(text)
        if self._always_frame:
            ids = [self._cls] + ids + [self._sep]
        return self._frame(ids, max_length)

    def encode_many(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> List[List[int]]:
        return [self.encode(t, max_length=max_length) for t in texts]

    def _frame(self, ids: List[int], max_length: Optional[int]) -> List[int]:
        if not ids or ids[0] != self._cls:
            ids = [self._cls] + ids + [self._sep]
        if max_length is not None and len(ids) > max_length:
            # keep [CLS] ... [SEP] framing after truncation
            ids = ids[: max_length - 1] + [self._sep]
        return ids

    # -- vocabulary -----------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self._vocab) + sum(1 for c in self._added_ids if c not in self._vocab)

    @property
    def pad_id(self) -> int:
        return self._pad

    @property
    def cls_id(self) -> int:
        return self._cls

    @property
    def sep_id(self) -> int:
        return self._sep

    @property
    def mask_id(self) -> int:
        return self.token_to_id(MASK)

    def get_vocab(self) -> Dict[str, int]:
        """Token → id over the model vocabulary and the added tokens, as
        ``tokenizers``' ``get_vocab()`` gives it."""
        vocab = dict(self._vocab)
        vocab.update(self._added_ids)
        return vocab

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._added_ids:
            return self._added_ids[token]
        return self._vocab.get(token)

    def save(self, path: Union[str, Path]) -> None:
        """Write a tokenizer.json in the ``tokenizers`` library's layout, so
        either package can load it."""
        n = self._normalizer
        special = lambda tok, type_id: {"SpecialToken": {"id": tok, "type_id": type_id}}
        seq = lambda name, type_id: {"Sequence": {"id": name, "type_id": type_id}}
        spec = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": [
                {"id": i, "content": c, "single_word": False, "lstrip": False,
                 "rstrip": False, "normalized": normalized, "special": True}
                for c, i, normalized in self._added
            ],
            "normalizer": {
                "type": "BertNormalizer", "clean_text": n.clean_text,
                "handle_chinese_chars": n.handle_chinese_chars,
                "strip_accents": None if n.strip_accents == n.lowercase else n.strip_accents,
                "lowercase": n.lowercase,
            },
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {
                "type": "TemplateProcessing",
                "single": [special(CLS, 0), seq("A", 0), special(SEP, 0)],
                "pair": [special(CLS, 0), seq("A", 0), special(SEP, 0),
                         seq("B", 1), special(SEP, 1)],
                "special_tokens": {
                    tok: {"id": tok, "ids": [self.token_to_id(tok)], "tokens": [tok]}
                    for tok in (CLS, SEP)
                },
            },
            "decoder": None,
            "model": {
                "type": "WordPiece", "unk_token": self._unk_token,
                "continuing_subword_prefix": self._prefix,
                "max_input_chars_per_word": self._max_chars,
                "vocab": dict(sorted(self._vocab.items(), key=lambda kv: kv[1])),
            },
        }
        Path(path).write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")

    def save_vocab_txt(self, path: Union[str, Path]) -> None:
        """Write the vocabulary as a bert-style ``vocab.txt`` (one token per
        line, in id order, added tokens included)."""
        ordered = sorted(self.get_vocab().items(), key=lambda kv: kv[1])
        if [i for _, i in ordered] != list(range(len(ordered))):
            raise ValueError(f"vocab ids are not contiguous 0..{len(ordered) - 1}")
        Path(path).write_text("\n".join(t for t, _ in ordered) + "\n", encoding="utf-8")


@TextTokenizer.register("word")
class WordTokenizer(TextTokenizer):
    """Word-level tokenizer of the TextCNN baseline, the port's counterpart
    of ``memvul_tpu.data.tokenizer.WordTokenizer``: lowercased runs of
    letters, runs of digits and single other non-space characters, looked
    up in a corpus-built vocabulary (0 = [PAD], 1 = [UNK]); no framing."""

    _WORDS = re.compile(r"[a-zA-Z]+|[0-9]+|[^\sa-zA-Z0-9]")

    def __init__(
        self,
        vocab: Optional[Dict[str, int]] = None,
        vocab_path: Optional[Union[str, Path]] = None,
        lowercase: bool = True,
    ) -> None:
        if vocab is None:
            if vocab_path is None:
                raise ValueError("need vocab or vocab_path")
            vocab = json.loads(Path(vocab_path).read_text())
        self._vocab = vocab
        self._lowercase = lowercase

    @classmethod
    def train_from_corpus(
        cls,
        texts: Iterable[str],
        max_vocab: int = 50_000,
        min_count: int = 1,
        lowercase: bool = True,
        save_path: Optional[Union[str, Path]] = None,
    ) -> "WordTokenizer":
        """The ``max_vocab - 2`` most frequent words seen ``min_count``
        times or more, after [PAD] and [UNK] (ties in first-seen order)."""
        counts: Counter = Counter()
        for text in texts:
            counts.update(cls._split(text, lowercase))
        vocab = {PAD: 0, UNK: 1}
        for word, c in counts.most_common(max_vocab - 2):
            if c < min_count:
                break
            vocab[word] = len(vocab)
        if save_path is not None:
            Path(save_path).write_text(json.dumps(vocab))
        return cls(vocab=vocab, lowercase=lowercase)

    @classmethod
    def _split(cls, text: str, lowercase: bool) -> List[str]:
        if lowercase:
            text = text.lower()
        return cls._WORDS.findall(text)

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        unk = self._vocab[UNK]
        ids = [self._vocab.get(w, unk) for w in self._split(text, self._lowercase)]
        if max_length is not None:
            ids = ids[:max_length]
        return ids or [unk]

    def encode_many(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> List[List[int]]:
        return [self.encode(t, max_length=max_length) for t in texts]

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    @property
    def pad_id(self) -> int:
        return self._vocab[PAD]

    @property
    def vocab_words(self) -> List[str]:
        return [w for w, _ in sorted(self._vocab.items(), key=lambda kv: kv[1])]


def _read_vocab(vocab_path: str) -> Dict[str, int]:
    if vocab_path.endswith(".json"):
        return json.loads(Path(vocab_path).read_text(encoding="utf-8"))
    return {
        line.rstrip("\n"): i
        for i, line in enumerate(Path(vocab_path).read_text(encoding="utf-8").splitlines())
    }


def _matcher(tokens: List[Tuple[str, int]]):
    """A leftmost-longest matcher over literal tokens: a regex alternation
    ordered longest first, plus the content → id map."""
    tokens = [(c, i) for c, i in tokens if c]
    if not tokens:
        return None
    ids = {c: i for c, i in tokens}
    ordered = sorted(ids, key=len, reverse=True)
    return re.compile("|".join(re.escape(c) for c in ordered)), ids


def _split(text: str, matcher) -> List[Tuple[str, Optional[int]]]:
    """``text`` cut at every added-token match: (segment, None) for plain
    text, (content, id) for a match; empty segments are dropped."""
    if matcher is None:
        return [(text, None)] if text else []
    pattern, ids = matcher
    out: List[Tuple[str, Optional[int]]] = []
    pos = 0
    for m in pattern.finditer(text):
        if m.start() > pos:
            out.append((text[pos : m.start()], None))
        out.append((m.group(0), ids[m.group(0)]))
        pos = m.end()
    if pos < len(text):
        out.append((text[pos:], None))
    return out
