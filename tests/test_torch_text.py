"""The port's byte-level BPE tokenizer (``text.py``) against the JAX
package's: the same merges, the same ids, the same round trip, on the same
corpora (``tests/test_text.py``'s nine cases, each also held to JAX)."""

import time
from collections import Counter

import numpy as np
import pytest

from tensorframes_tpu.text import BPETokenizer as JaxBPE
from tensorframes_tpu_torch.text import BPETokenizer

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the quick brown fox is quick and the dog is lazy",
    "pack my box with five dozen liquor jugs",
] * 4
EXTRA = ["völlig neu! 日本語 🙂", "", "  spaces  "]


def test_roundtrip_exact_and_ids_match_jax():
    tok, ref = BPETokenizer.train(CORPUS, 300), JaxBPE.train(CORPUS, 300)
    for s in CORPUS + EXTRA:
        assert tok.encode(s) == ref.encode(s)
        assert tok.decode(tok.encode(s)) == s


def test_training_compresses_as_jax():
    tok, ref = BPETokenizer.train(CORPUS, 320), JaxBPE.train(CORPUS, 320)
    ids = tok.encode(CORPUS[0])
    assert ids == ref.encode(CORPUS[0])
    assert len(ids) < len(CORPUS[0].encode("utf-8"))
    assert max(ids) >= 256
    assert tok.vocab_size == ref.vocab_size <= 320


def test_deterministic_merges_equal_jax():
    a = BPETokenizer.train(CORPUS, 300).merges
    assert a == BPETokenizer.train(list(CORPUS), 300).merges
    assert [tuple(m) for m in a] == [tuple(m) for m in JaxBPE.train(CORPUS, 300).merges]


def test_untrained_is_raw_bytes():
    tok = BPETokenizer()
    assert tok.encode("ab c") == [97, 98, 32, 99] == JaxBPE().encode("ab c")
    assert tok.vocab_size == 256


def test_save_load_across_packages(tmp_path):
    """A vocabulary saved by either package loads in the other."""
    tok = BPETokenizer.train(CORPUS, 280)
    p = str(tmp_path / "bpe.json")
    tok.save(p)
    assert BPETokenizer.load(p).merges == tok.merges
    ref = JaxBPE.load(p)
    assert ref.encode("the quick dog") == tok.encode("the quick dog")
    q = str(tmp_path / "jax_bpe.json")
    JaxBPE.train(CORPUS, 280).save(q)
    assert BPETokenizer.load(q).encode("the quick dog") == tok.encode("the quick dog")


def test_vocab_floor_validated_as_jax():
    with pytest.raises(ValueError, match=">= 256") as te:
        BPETokenizer.train(CORPUS, 100)
    with pytest.raises(ValueError) as je:
        JaxBPE.train(CORPUS, 100)
    assert str(te.value) == str(je.value)


def test_text_to_training_pipeline():
    """The front door: text -> BPE -> the port's packed frame columns."""
    from tensorframes_tpu_torch.data import pack_examples

    tok = BPETokenizer.train(CORPUS, 300)
    seqs = [np.asarray(tok.encode(s)) for s in CORPUS]
    toks, segs, pos = pack_examples(seqs, 32)
    assert toks.max() < tok.vocab_size
    row0 = toks[0][segs[0] == 1]
    assert tok.decode(row0.tolist()) in CORPUS[0]


def _naive_train_merges(texts, vocab_size):
    words = Counter()
    for t in texts:
        for w in t.split(" "):
            words[w.encode("utf-8")] += 1
    seqs = {tuple(w): c for w, c in words.items() if w}
    merges = []
    while 256 + len(merges) < vocab_size:
        pairs = Counter()
        for seq, c in seqs.items():
            for pair in zip(seq, seq[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        if pairs[best] < 2:
            break
        new_id = 256 + len(merges)
        merges.append(best)
        merged = {}
        for seq, c in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == best:
                    out.append(new_id)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + c
        seqs = merged
    return merges


def test_incremental_train_matches_naive_and_jax():
    rng = np.random.RandomState(0)
    vocab = ["the", "cat", "sat", "saturday", "thethe", "aaaa", "ab"]
    corpus = [" ".join(rng.choice(vocab, size=50)) for _ in range(40)] + [
        "überraschung überraschung ßß"
    ]
    got = [tuple(m) for m in BPETokenizer.train(corpus, 256 + 60).merges]
    assert got == [tuple(m) for m in _naive_train_merges(corpus, 256 + 60)]
    assert got == [tuple(m) for m in JaxBPE.train(corpus, 256 + 60).merges]


def test_train_scales_and_matches_jax():
    """2k merges over a ~400 KB zipf-skewed corpus: the incremental trainer
    stays fast, compresses, and learns JAX's merges exactly."""
    rng = np.random.RandomState(1)
    roots = [
        "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), size=rng.randint(3, 12)))
        for _ in range(2000)
    ]
    zipf = rng.zipf(1.3, size=60_000) % len(roots)
    corpus = [" ".join(roots[i] for i in zipf[k::50]) for k in range(50)]
    assert sum(len(c) for c in corpus) > 200_000
    t0 = time.perf_counter()
    tok = BPETokenizer.train(corpus, 256 + 2048)
    dt = time.perf_counter() - t0
    assert dt < 30, f"incremental BPE took {dt:.1f}s"
    assert tok.merges == JaxBPE.train(corpus, 256 + 2048).merges
    sample = corpus[0][:2000]
    assert len(tok.encode(sample)) < len(sample.encode("utf-8")) * 0.7
