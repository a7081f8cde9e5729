"""The port's data plane for training against the JAX package's:
``FrameLoader`` (ports of ``tests/test_train_data.py``'s loader tests, and
the same batches as JAX's for the same seed), the packing helpers (arrays
equal exactly), and ``full_attention`` with packed-sequence segments
(f32, ``rtol=atol=2e-5``: summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import data as jdata
from tensorframes_tpu.parallel.ring import full_attention as j_full
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import data as tdata
from tensorframes_tpu_torch.parallel.ring import full_attention as t_full


def _rows(n_rows=24, seq=8, seed=0):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, 32, size=(n_rows, 1))
    return ((start + np.arange(seq + 1)) % 32).astype(np.int32)


def token_frame(n_rows=24, seq=8, blocks=3, seed=0):
    return tft.analyze(
        tft.TensorFrame.from_arrays({"tokens": _rows(n_rows, seq, seed)}, num_blocks=blocks)
    )


def _loader(frame, **kw):
    return tdata.FrameLoader(frame, device="cpu", **kw)


def test_loader_batches_shapes_and_content():
    f = token_frame(n_rows=10, seq=4)
    loader = _loader(f, batch_size=4)  # drop_remainder: 2 batches
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    assert all(isinstance(b["tokens"], torch.Tensor) for b in batches)
    all_rows = np.concatenate([b["tokens"].numpy() for b in batches])
    np.testing.assert_array_equal(all_rows, np.asarray(f.column("tokens").data)[:8])


def test_loader_keep_remainder():
    f = token_frame(n_rows=10, seq=4)
    loader = _loader(f, batch_size=4, drop_remainder=False)
    assert [b["tokens"].shape[0] for b in loader] == [4, 4, 2]


def test_loader_shuffle_deterministic_and_complete():
    f = token_frame(n_rows=12, seq=4)

    def mk():
        return _loader(f, batch_size=4, shuffle=True, seed=7)

    e0a = [b["tokens"].numpy() for b in mk().epoch(0)]
    e0b = [b["tokens"].numpy() for b in mk().epoch(0)]
    e1 = [b["tokens"].numpy() for b in mk().epoch(1)]
    for a, b in zip(e0a, e0b):
        np.testing.assert_array_equal(a, b)  # same epoch -> same order
    assert any((a != b).any() for a, b in zip(e0a, e1))  # reshuffled
    ref = np.sort(np.asarray(f.column("tokens").data), axis=0)
    np.testing.assert_array_equal(np.sort(np.concatenate(e0a), axis=0), ref)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_gives_the_jax_loaders_batches(shuffle, prefetch):
    rows = _rows(n_rows=20, seq=6, seed=3)
    jl = jdata.FrameLoader(
        tfs.TensorFrame.from_arrays({"tokens": rows}), batch_size=6,
        shuffle=shuffle, seed=5, prefetch=prefetch,
    )
    tl = _loader(tft.TensorFrame.from_arrays({"tokens": rows}), batch_size=6,
                 shuffle=shuffle, seed=5, prefetch=prefetch)
    for epoch in (0, 1):
        jb = [np.asarray(b["tokens"]) for b in jl.epoch(epoch)]
        tb = [b["tokens"].numpy() for b in tl.epoch(epoch)]
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b, a)


def test_loader_batches_are_copies_of_the_staging_rows():
    f = token_frame(n_rows=8, seq=4)
    loader = _loader(f, batch_size=4)
    first = next(iter(loader))["tokens"]
    first.zero_()  # a caller's in-place edit must not reach the next epoch
    again = next(iter(loader))["tokens"].numpy()
    np.testing.assert_array_equal(again, np.asarray(f.column("tokens").data)[:4])


def test_loader_takes_tensor_columns():
    rows = _rows(n_rows=8, seq=4)
    f = tft.TensorFrame.from_arrays({"tokens": torch.from_numpy(rows)})
    got = np.concatenate([b["tokens"].numpy() for b in _loader(f, batch_size=4)])
    np.testing.assert_array_equal(got, rows)


def test_loader_rejects_ragged_and_binary_like_jax():
    cells = [{"v": [1.0]}, {"v": [1.0, 2.0]}]
    for jframe, tframe in (
        (tfs.TensorFrame.from_rows(cells), tft.TensorFrame.from_rows(cells)),
        (tfs.TensorFrame.from_arrays({"b": [b"x", b"y"]}),
         tft.TensorFrame.from_arrays({"b": [b"x", b"y"]})),
    ):
        with pytest.raises(ValueError) as je:
            jdata.FrameLoader(jframe, batch_size=1)
        with pytest.raises(ValueError) as te:
            _loader(tframe, batch_size=1)
        assert str(je.value) == str(te.value)
        assert "ragged" in str(te.value) or "host-only" in str(te.value)


@pytest.mark.parametrize(
    "kw", [{"batch_size": 0}, {"batch_size": 30}], ids=["zero", "too-large"]
)
def test_loader_size_errors_match_jax(kw):
    rows = _rows(n_rows=10, seq=4)
    with pytest.raises(ValueError) as je:
        jdata.FrameLoader(tfs.TensorFrame.from_arrays({"tokens": rows}), **kw)
    with pytest.raises(ValueError) as te:
        _loader(tft.TensorFrame.from_arrays({"tokens": rows}), **kw)
    assert str(je.value) == str(te.value)


def test_loader_mesh_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 13"):
        _loader(token_frame(n_rows=16, seq=4), batch_size=8, mesh=object())


def test_loader_forever_cycles_epochs():
    loader = _loader(token_frame(n_rows=8, seq=4), batch_size=4, shuffle=True)
    it = loader.forever()
    got = [next(it)["tokens"].numpy() for _ in range(4)]
    ref = [b["tokens"].numpy() for e in (0, 1) for b in loader.epoch(e)]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_lm_split():
    x, y = tdata.lm_split({"tokens": torch.arange(10).reshape(2, 5)})
    np.testing.assert_array_equal(x.numpy(), [[0, 1, 2, 3], [5, 6, 7, 8]])
    np.testing.assert_array_equal(y.numpy(), [[1, 2, 3, 4], [6, 7, 8, 9]])


# -- packing -----------------------------------------------------------------


def _corpus(seed=0, n=60):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 32, k) for k in rng.randint(1, 30, n)]


@pytest.mark.parametrize("seq_len,pad_id", [(16, 0), (9, 5)])
def test_pack_examples_equals_jax(seq_len, pad_id):
    corpus = _corpus()
    for j, t in zip(jdata.pack_examples(corpus, seq_len, pad_id),
                    tdata.pack_examples(corpus, seq_len, pad_id)):
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, j)


def test_lm_split_packed_equals_jax_on_numpy_and_tensors():
    toks, segs, pos = jdata.pack_examples(_corpus(1), 12)
    ref = jdata.lm_split_packed(toks, segs, pos)
    for t, j in zip(tdata.lm_split_packed(toks, segs, pos), ref):
        np.testing.assert_array_equal(t, j)
    tensors = [torch.from_numpy(x) for x in (toks, segs, pos)]
    for t, j in zip(tdata.lm_split_packed(*tensors), ref):
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), j)


def test_packed_frame_equals_jax():
    corpus = _corpus(2)
    jf = jdata.packed_frame(corpus, seq_len=16, num_blocks=4)
    tf = tdata.packed_frame(corpus, seq_len=16, num_blocks=4)
    assert jf.column_names == tf.column_names == ["tokens", "segments", "positions"]
    assert jf.offsets == tf.offsets
    assert jf.schema.explain() == tf.schema.explain()
    for name in jf.column_names:
        np.testing.assert_array_equal(
            np.asarray(tf.column(name).data), np.asarray(jf.column(name).data)
        )


# -- full attention with segments --------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_with_segments_matches_jax(causal):
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 12, 2, 8).astype(np.float32) for _ in range(3))
    segs = np.sort(rng.randint(0, 4, (2, 12)), axis=1).astype(np.int32)
    pos = np.concatenate(
        [np.arange(12)[None] for _ in range(2)]
    ).astype(np.int32)
    j = j_full(*(jnp.asarray(x) for x in (q, k, v)), causal,
               jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(segs), jnp.asarray(segs))
    t = t_full(*(torch.from_numpy(x) for x in (q, k, v)), causal,
               torch.from_numpy(pos), torch.from_numpy(pos),
               torch.from_numpy(segs), torch.from_numpy(segs))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5, atol=2e-5)


def test_segments_keep_tokens_inside_their_segment():
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 6, 1, 4).astype(np.float32)) for _ in range(3))
    segs = torch.tensor([[1, 1, 1, 2, 2, 2]])
    both = t_full(q, k, v, True, segments_q=segs, segments_k=segs)
    first = t_full(q[:, :3], k[:, :3], v[:, :3], True)
    second = t_full(q[:, 3:], k[:, 3:], v[:, 3:], True)
    torch.testing.assert_close(both, torch.cat([first, second], 1))
