"""A plain BERT WordPiece tokenizer for ASCII text, frozen with the benchmark.

It is the reference's own tokenizer and shares no code with the program's:
lowercase, tab, newline and carriage return become spaces and other ASCII
control characters are dropped, words split on whitespace, every ASCII
punctuation character (33-47, 58-64, 91-96, 123-126) stands alone, and each
word is cut greedily into the longest vocabulary pieces, continuation pieces
carrying ``##``.  A word longer than 100 characters, or one that cannot be
cut, is ``[UNK]``.  A sequence is framed ``[CLS] ... [SEP]`` and truncated to
``max_length`` keeping its ``[SEP]``.  Text outside ASCII raises: the
benchmark's traffic is ASCII.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

_PUNCT = r"!-/:-@\[-`{-~"
_WORDS = re.compile(rf"[^ {_PUNCT}]+|[{_PUNCT}]")
_CLEAN = {c: None for c in [*range(32), 127]}
_CLEAN.update({9: " ", 10: " ", 13: " "})
MAX_WORD_CHARS = 100


class WordPiece:
    def __init__(self, vocab: Sequence[str]) -> None:
        self.ids: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.unk = self.ids["[UNK]"]
        self.cls = self.ids["[CLS]"]
        self.sep = self.ids["[SEP]"]
        self._cache: Dict[str, List[int]] = {}

    def words(self, text: str) -> List[str]:
        if not text.isascii():
            raise ValueError("the reference tokenizer reads ASCII text only")
        return _WORDS.findall(text.translate(_CLEAN).lower())

    def word_pieces(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        pieces: List[int] = []
        if len(word) > MAX_WORD_CHARS:
            pieces = [self.unk]
        else:
            start = 0
            while start < len(word):
                end = len(word)
                found = None
                while end > start:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    found = self.ids.get(piece)
                    if found is not None:
                        break
                    end -= 1
                if found is None:
                    pieces = [self.unk]
                    break
                pieces.append(found)
                start = end
        self._cache[word] = pieces
        return pieces

    def pieces(self, text: str) -> List[int]:
        """The wordpiece ids of ``text``, unframed."""
        out: List[int] = []
        for word in self.words(text):
            out.extend(self.word_pieces(word))
        return out

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [self.cls] + self.pieces(text) + [self.sep]
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep]
        return ids
