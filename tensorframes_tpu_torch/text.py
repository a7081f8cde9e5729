"""Byte-level BPE tokenizer: the text -> tokens front door.

The port's own copy of ``tensorframes_tpu/text.py`` (pure Python and
NumPy, no framework), so the port never imports the JAX package.  Design:

* **byte-level base vocabulary** (ids 0-255): any UTF-8 string encodes
  without an unknown token, and ``decode(encode(s)) == s`` exactly;
* classic BPE training -- iteratively merge the most frequent adjacent
  pair -- on a whitespace-delimited word histogram (merges never cross
  word boundaries);
* deterministic: ties break lexicographically, so identical corpora give
  identical vocabularies (and ids) in both packages and on every host;
* host-side: tokenization is data-plane preprocessing
  (``data.pack_examples`` / ``FrameLoader`` take it from there).

Training is incremental: pair counts live in a dict updated by deltas,
the argmax comes from a lazy max-heap, and each merge touches only the
words that contain the merged pair -- the textbook algorithm's output
(same counts, same tie-break) in far less time.
"""

from __future__ import annotations

import heapq
import json
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Set, Tuple

__all__ = ["BPETokenizer"]


class BPETokenizer:
    """Byte-level BPE.  ``train`` builds merges; ``encode``/``decode``
    round-trip any UTF-8 text exactly."""

    def __init__(self, merges: Sequence[Tuple[int, int]] = ()):
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        # merged pair -> new token id (ids 256.. in merge order)
        self._ranks: Dict[Tuple[int, int], int] = {
            tuple(m): 256 + i for i, m in enumerate(self.merges)
        }
        # token id -> raw bytes
        self._bytes: List[bytes] = [bytes([b]) for b in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])

    # -- training -----------------------------------------------------------

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int) -> "BPETokenizer":
        """Learn ``vocab_size - 256`` merges from the corpus.

        Incremental: per merge, only the words CONTAINING the merged pair
        are re-tokenised, their pair-count deltas applied to one running
        dict, and the next argmax served by a lazy max-heap (stale heap
        entries — counts that changed since push — are skipped on pop).
        Output is identical to the naive full-rescan algorithm: same
        greedy choice each step, ties broken by the lexicographically
        smallest pair."""
        if vocab_size < 256:
            raise ValueError("byte-level vocab needs vocab_size >= 256")
        words = Counter()
        for t in texts:
            for w in t.split(" "):
                if w:
                    words[w.encode("utf-8")] += 1
        seqs: List[List[int]] = [list(w) for w in words]
        counts: List[int] = list(words.values())

        pair_counts: Dict[Tuple[int, int], int] = {}
        pair_words: Dict[Tuple[int, int], Set[int]] = {}
        for idx, (seq, c) in enumerate(zip(seqs, counts)):
            for p in zip(seq, seq[1:]):
                pair_counts[p] = pair_counts.get(p, 0) + c
                pair_words.setdefault(p, set()).add(idx)
        heap = [(-cnt, p) for p, cnt in pair_counts.items()]
        heapq.heapify(heap)

        merges: List[Tuple[int, int]] = []
        while 256 + len(merges) < vocab_size:
            best = None
            while heap:
                negc, p = heapq.heappop(heap)
                if pair_counts.get(p, 0) == -negc:
                    best = p
                    best_count = -negc
                    break
            if best is None or best_count < 2:
                break  # nothing repeats: further merges are noise
            new_id = 256 + len(merges)
            merges.append(best)

            changed: Dict[Tuple[int, int], int] = {}
            for idx in pair_words.pop(best, ()):  # lazy sets: verify below
                seq, c = seqs[idx], counts[idx]
                found = any(
                    (seq[i], seq[i + 1]) == best
                    for i in range(len(seq) - 1)
                )
                if not found:
                    continue  # stale membership from an earlier re-merge
                for p in zip(seq, seq[1:]):
                    changed[p] = changed.get(p, 0) - c
                out: List[int] = []
                i = 0
                while i < len(seq):
                    if i + 1 < len(seq) and (seq[i], seq[i + 1]) == best:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                for p in zip(out, out[1:]):
                    changed[p] = changed.get(p, 0) + c
                    pair_words.setdefault(p, set()).add(idx)
                seqs[idx] = out
            for p, d in changed.items():
                if d == 0:
                    continue
                nc = pair_counts.get(p, 0) + d
                if nc <= 0:
                    pair_counts.pop(p, None)
                    # a dead old-id pair can never re-form (new
                    # adjacencies always involve the new merge id), so
                    # its word-index set is garbage — free it, bounding
                    # peak memory to the LIVE pairs
                    pair_words.pop(p, None)
                else:
                    pair_counts[p] = nc
                    heapq.heappush(heap, (-nc, p))
            pair_counts.pop(best, None)
        return cls(merges)

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    # -- encode / decode ----------------------------------------------------

    def _encode_word(self, word: bytes) -> List[int]:
        seq = list(word)
        while len(seq) > 1:
            # lowest-rank (earliest-learned) applicable merge first — the
            # canonical BPE application order
            ranked = [
                (self._ranks[p], i)
                for i, p in enumerate(zip(seq, seq[1:]))
                if p in self._ranks
            ]
            if not ranked:
                break
            rank, i = min(ranked)
            seq[i : i + 2] = [rank]
        return seq

    def encode(self, text: str) -> List[int]:
        """UTF-8 text -> token ids.  Spaces delimit words and encode as
        their own byte token (32), mirroring training's word split."""
        ids: List[int] = []
        first = True
        for w in text.split(" "):
            if not first:
                ids.append(32)
            first = False
            if w:
                ids.extend(self._encode_word(w.encode("utf-8")))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = b"".join(self._bytes[int(i)] for i in ids)
        return data.decode("utf-8", errors="replace")

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            return cls(json.load(f)["merges"])
