"""Query vocabulary — a copy of ``zsgnet_tpu/data/vocab.py``.

Whitespace tokenization over pre-tokenized text, word→id map with PAD=0
and UNK=1, saved as JSON, so a ``vocab.json`` written by either package
loads in the other with the same ids.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from pathlib import Path
from typing import Iterable

PAD_ID = 0
UNK_ID = 1
_SPECIALS = ("<pad>", "<unk>")


def tokenize(query: str) -> list[str]:
    """Whitespace tokenization (datasets ship pre-tokenized queries)."""
    return query.lower().strip().split()


class Vocab:
    def __init__(self, word_to_id: dict[str, int]):
        self.word_to_id = word_to_id
        self.id_to_word = {i: w for w, i in word_to_id.items()}

    def __len__(self) -> int:
        return len(self.word_to_id)

    @classmethod
    def build(cls, queries: Iterable[str], min_freq: int = 1) -> "Vocab":
        counts: Counter[str] = Counter()
        for q in queries:
            counts.update(tokenize(q))
        word_to_id = {w: i for i, w in enumerate(_SPECIALS)}
        for w, c in sorted(counts.items()):
            if c >= min_freq and w not in word_to_id:
                word_to_id[w] = len(word_to_id)
        return cls(word_to_id)

    def add_word(self, word: str) -> int:
        """Append ``word`` with the next free id and return its id (the id
        it already has if it is known). Ids only grow, so every query
        encoded before keeps its ids; the caller keeps the embedding table
        in step (``predict.Grounder`` reserves its rows up front)."""
        if word in self.word_to_id:
            return self.word_to_id[word]
        idx = len(self.word_to_id)
        self.word_to_id[word] = idx
        self.id_to_word[idx] = word
        return idx

    def encode(self, query: str, max_len: int) -> tuple[list[int], int]:
        """→ (padded id list of length max_len, true length ≥ 1)."""
        ids = [self.word_to_id.get(w, UNK_ID) for w in tokenize(query)][:max_len]
        if not ids:
            ids = [UNK_ID]
        length = len(ids)
        return ids + [PAD_ID] * (max_len - length), length

    def save(self, path: str | Path) -> None:
        """Written under a temporary name and moved into place, so a reader
        in another process (a rank of a data-parallel run) never sees a
        partial file."""
        path = Path(path)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(self.word_to_id, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str | Path) -> "Vocab":
        with open(path) as f:
            return cls(json.load(f))
