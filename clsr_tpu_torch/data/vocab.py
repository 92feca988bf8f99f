"""Vocabularies: token -> contiguous id, id 0 reserved for OOV.

Counterpart of clsr_tpu/data/vocab.py, same pickle format: a plain dict
`{"default_mid": 0, ...}`, interoperable with the reference's vocab
pickles (sequential_reviews.py:77-145, deeprec_utils.py:824-835).
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterable, List


class Vocab:
    """String-token vocabulary with id 0 = OOV default."""

    def __init__(self, mapping: Dict[str, int]):
        self._map = mapping

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, token: str) -> bool:
        return token in self._map

    def lookup(self, token: str) -> int:
        """OOV maps to 0, like sequential_iterator.py:105-107."""
        return self._map.get(token, 0)

    def lookup_many(self, tokens: Iterable[str]) -> List[int]:
        get = self._map.get
        return [get(t, 0) for t in tokens]

    @classmethod
    def from_counts(cls, counts: Dict[str, int],
                    default_token: str = "default") -> "Vocab":
        """Frequency-sorted vocab with the default token at id 0
        (sequential_reviews.py:77-145): descending count, ties by token."""
        mapping = {default_token: 0}
        for i, (token, _) in enumerate(
                sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))):
            mapping[token] = i + 1
        return cls(mapping)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self._map, f)

    @property
    def mapping(self) -> Dict[str, int]:
        return self._map


def load_vocab(path: str) -> Vocab:
    """Read a vocab pickle written by this package, clsr_tpu or the
    reference's ETL; unpickle only such trusted files."""
    with open(path, "rb") as f:
        return Vocab(pickle.load(f))
