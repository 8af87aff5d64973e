"""Pretrained word embeddings (GloVe / word2vec text format) — port of
``zsgnet_tpu/data/embeddings.py``.

``load_embedding_table`` reads ``word v1 … vD`` lines into a (V, D) table
for a :class:`Vocab`: the file's vector for every word it has, a seeded
normal(0, 0.6·std) row for every other word, and zeros for PAD. The rows
are the JAX package's bit for bit (the same numpy generator, seed and
order). The Learner copies the table into ``model.embedding.weight`` when
``cfg.glove_path`` is set.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from zsgnet_tpu_torch.data.vocab import PAD_ID, Vocab


def load_embedding_table(
    path: str | Path, vocab: Vocab, emb_dim: int, seed: int = 0
) -> tuple[np.ndarray, int]:
    """→ ((V, emb_dim) float32 table, number of vocab words found in the file)."""
    wanted = vocab.word_to_id
    table = np.zeros((len(vocab), emb_dim), np.float32)
    hit = np.zeros(len(vocab), dtype=bool)
    found = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < emb_dim + 1:
                continue  # a word2vec header line or a malformed row
            idx = wanted.get(parts[0])
            if idx is None:
                continue
            table[idx] = np.asarray(parts[1 : emb_dim + 1], dtype=np.float32)
            hit[idx] = True
            found += 1
    rng = np.random.default_rng(seed)
    scale = float(table[hit].std()) * 0.6 if found else 0.1
    for i in range(len(vocab)):
        if not hit[i] and i != PAD_ID:
            table[i] = rng.normal(0, scale, emb_dim).astype(np.float32)
    table[PAD_ID] = 0.0
    return table, found
