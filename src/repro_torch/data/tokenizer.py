"""Minimal tokenizer layer (a copy of the JAX package's, pure Python).

The synthetic corpora generate token ids directly; this module exists so
the examples can also ingest real text files.  ``Vocab`` maps strings to
contiguous ids; ``HashTokenizer`` is an open-vocabulary fallback that
buckets unseen words (the paper assumes queries stay in-vocabulary,
Sec. V — we keep that assumption for query words but not for corpus
ingestion).
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

_WORD_RE = re.compile(r"[a-z0-9']+")


def simple_word_split(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


class Vocab:
    def __init__(self, words: Optional[Iterable[str]] = None):
        self._w2i: Dict[str, int] = {}
        self._i2w: List[str] = []
        if words:
            for w in words:
                self.add(w)

    def add(self, word: str) -> int:
        idx = self._w2i.get(word)
        if idx is None:
            idx = len(self._i2w)
            self._w2i[word] = idx
            self._i2w.append(word)
        return idx

    def __len__(self) -> int:
        return len(self._i2w)

    def __contains__(self, word: str) -> bool:
        return word in self._w2i

    def id(self, word: str) -> int:
        return self._w2i[word]

    def word(self, idx: int) -> str:
        return self._i2w[idx]

    @staticmethod
    def build(texts: Iterable[str], max_size: int = 1 << 17) -> "Vocab":
        from collections import Counter
        counts: Counter = Counter()
        for t in texts:
            counts.update(simple_word_split(t))
        vocab = Vocab()
        for w, _ in counts.most_common(max_size):
            vocab.add(w)
        return vocab


class HashTokenizer:
    """Tokenize with a closed vocab; hash OOV words into reserved buckets."""

    def __init__(self, vocab: Vocab, oov_buckets: int = 1024):
        self.vocab = vocab
        self.oov_buckets = oov_buckets

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + self.oov_buckets

    def encode(self, text: str):
        import numpy as np
        ids = []
        base = len(self.vocab)
        for w in simple_word_split(text):
            if w in self.vocab:
                ids.append(self.vocab.id(w))
            else:
                ids.append(base + (hash(w) % self.oov_buckets))
        return np.asarray(ids, np.int32)
