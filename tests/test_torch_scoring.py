"""The slice as a whole: the same multi-block ``tokens`` frame scored by the
JAX package (``tfs.map_blocks(scoring_program(...))``) and by the port
(``tensorframes_tpu_torch.map_blocks(..., device="cpu")``) on the same
weights.

f32 models, tolerance ``rtol=atol=1e-5`` (summation order of two CPU
backends); schemas, column order and error messages must be identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu.models import scoring as jscoring
from tensorframes_tpu.models import transformer as jtfm
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import convert
from tensorframes_tpu_torch.models import scoring as tscoring

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = dict(
    vocab_size=32, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
    d_ff=64, max_seq=16, dtype=jnp.float32,
)
ALL = ("nll", "perplexity", "embedding")


def _models(seed=0, **over):
    jcfg = jtfm.TransformerConfig(**{**FIELDS, **over})
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jtfm.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _frames(cols, num_blocks=3):
    return (
        tfs.TensorFrame.from_arrays(cols, num_blocks=num_blocks),
        tft.TensorFrame.from_arrays(cols, num_blocks=num_blocks),
    )


def _tokens(n=10, L=8, seed=0, pad_id=None):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, 32, (n, L)).astype(np.int32)
    if pad_id is not None:  # ragged tail padding, as scoring expects
        for i, keep in enumerate(rng.randint(2, L + 1, n)):
            toks[i, keep:] = pad_id
    return toks


def _assert_outputs_match(jout, tout, names=ALL):
    assert jout.column_names == tout.column_names
    assert jout.schema.explain() == tout.schema.explain()
    assert jout.offsets == tout.offsets
    ja, ta = jout.to_arrays(), tout.to_arrays()
    for name in names:
        assert ta[name].dtype == np.asarray(ja[name]).dtype
        np.testing.assert_allclose(ta[name], np.asarray(ja[name]), **TOL)


@pytest.mark.parametrize(
    "over",
    [{"attn_impl": "full"}, {"attn_impl": "flash"},
     {"attn_impl": "flash", "n_heads": 4, "n_kv_heads": 2},
     {"attn_impl": "full", "n_heads": 4, "n_kv_heads": 2}],
    ids=["full", "flash", "flash-gqa", "full-gqa"],
)
def test_scoring_through_map_blocks_matches_jax(over):
    jcfg, tcfg, jp, tp = _models(**over)
    jf, tf = _frames({"tokens": _tokens(), "id": np.arange(10)})
    jout = tfs.map_blocks(jscoring.scoring_program(jp, jcfg, fetches=ALL), jf)
    tout = tft.map_blocks(
        tscoring.scoring_program(tp, tcfg, fetches=ALL, device="cpu"), tf
    )
    _assert_outputs_match(jout, tout)
    # outputs sorted by name, then the passthrough columns in frame order
    assert tout.column_names == ["embedding", "nll", "perplexity", "tokens", "id"]
    assert isinstance(tout.column("nll").data, torch.Tensor)
    np.testing.assert_array_equal(tout.to_arrays()["id"], np.arange(10))


def test_scoring_with_pad_id_and_column_matches_jax():
    jcfg, tcfg, jp, tp = _models(seed=1, attn_impl="flash")
    toks = _tokens(seed=2, pad_id=0)
    jf, tf = _frames({"text": toks})
    kw = dict(fetches=ALL, pad_id=0, column="text")
    jout = tfs.map_blocks(jscoring.scoring_program(jp, jcfg, **kw), jf)
    tout = tft.map_blocks(
        tscoring.scoring_program(tp, tcfg, device="cpu", **kw), tf
    )
    _assert_outputs_match(jout, tout)
    assert tout.column_names == ["embedding", "nll", "perplexity", "text"]


def test_output_shadows_passthrough_column_like_jax():
    jcfg, tcfg, jp, tp = _models(attn_impl="full")
    cols = {"nll": np.full(10, -1.0, np.float32), "tokens": _tokens(seed=3)}
    jf, tf = _frames(cols, num_blocks=2)
    jout = tfs.map_blocks(jscoring.scoring_program(jp, jcfg), jf)
    tout = tft.map_blocks(tscoring.scoring_program(tp, tcfg, device="cpu"), tf)
    _assert_outputs_match(jout, tout, names=("nll", "perplexity"))
    assert tout.column_names == ["nll", "perplexity", "tokens"]
    assert (tout.to_arrays()["nll"] > 0).all()  # the output, not the -1s


def test_map_blocks_device_argument():
    _, tcfg, _, tp = _models(attn_impl="full")
    _, tf = _frames({"tokens": _tokens()})
    prog = tscoring.scoring_program(tp, tcfg, device="cpu")
    a = tft.map_blocks(prog, tf).to_arrays()["nll"]
    b = tft.map_blocks(prog, tf, device="cpu").to_arrays()["nll"]
    np.testing.assert_array_equal(a, b)
    c = tft.Executor().map_blocks(prog, tf).to_arrays()["nll"]
    np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="params live on cpu"):
        tft.map_blocks(prog, tf, device="meta")


def test_trimmed_verb_matches_jax():
    x = np.random.RandomState(4).randn(9, 3).astype(np.float32)
    jf, tf = _frames({"x": x, "k": np.arange(9)}, num_blocks=3)
    jout = tfs.map_blocks_trimmed(
        lambda x: {"s": x.sum(axis=0, keepdims=True), "m": x.max(axis=0, keepdims=True)}, jf
    )
    tout = tft.map_blocks_trimmed(
        lambda x: {"s": x.sum(0, keepdim=True), "m": x.amax(0, keepdim=True)},
        tf, device="cpu",
    )
    _assert_outputs_match(jout, tout, names=("m", "s"))
    assert tout.column_names == ["m", "s"]  # no passthrough when trimmed
    assert tout.offsets == (0, 1, 2, 3)


def test_trimmed_row_count_disagreement_message_matches_jax():
    x = np.arange(6, dtype=np.float32).reshape(6, 1)
    jf, tf = _frames({"x": x}, num_blocks=2)
    with pytest.raises(tfs.ValidationError) as je:
        tfs.map_blocks_trimmed(lambda x: {"a": x[:1], "b": x}, jf)
    with pytest.raises(tft.ValidationError) as te:
        tft.map_blocks_trimmed(lambda x: {"a": x[:1], "b": x}, tf, device="cpu")
    assert str(je.value) == str(te.value)


def test_row_count_validation_error_matches_jax():
    jf, tf = _frames({"tokens": _tokens()})
    with pytest.raises(tfs.ValidationError) as je:
        tfs.map_blocks(lambda tokens: {"s": tokens[:1]}, jf)
    with pytest.raises(tft.ValidationError) as te:
        tft.map_blocks(lambda tokens: {"s": tokens[:1]}, tf, device="cpu")
    assert str(je.value) == str(te.value)
    assert "has shape (1, 8) but the input block has 4 rows" in str(te.value)


@pytest.mark.parametrize(
    "cols",
    [
        {"other": np.zeros((4, 8), np.int32)},  # TFS103
        {"tokens": [np.zeros(i + 1, np.int32) for i in range(4)]},  # TFS105
        {"tokens": np.array([b"a", b"b"], dtype=object)},  # TFS104
    ],
    ids=["missing", "unanalyzed", "host-only"],
)
def test_input_validation_errors_match_jax(cols):
    jf, tf = _frames(cols, num_blocks=1)
    with pytest.raises(tfs.ValidationError) as je:
        tfs.map_blocks(lambda tokens: {"s": tokens}, jf)
    with pytest.raises(tft.ValidationError) as te:
        tft.map_blocks(lambda tokens: {"s": tokens}, tf, device="cpu")
    assert str(je.value) == str(te.value)
    assert je.value.code == te.value.code


def test_empty_frame_output_schema_matches_jax():
    jcfg, tcfg, jp, tp = _models(attn_impl="flash")
    z = {"tokens": np.zeros((0, 8), np.int32), "id": np.zeros(0, np.int64)}
    jf, tf = _frames(z)
    jout = tfs.map_blocks(jscoring.scoring_program(jp, jcfg, fetches=ALL), jf)
    tout = tft.map_blocks(
        tscoring.scoring_program(tp, tcfg, fetches=ALL, device="cpu"), tf
    )
    assert repr(jout) == repr(tout)
    for name, arr in tout.to_arrays().items():
        assert arr.shape == np.asarray(jout.to_arrays()[name]).shape
        assert arr.dtype == np.asarray(jout.to_arrays()[name]).dtype


def test_update_params_changes_results_without_rebuilding():
    jcfg, tcfg, jp, tp = _models(attn_impl="flash")
    _, _, jp2, tp2 = _models(seed=7, attn_impl="flash")
    jf, tf = _frames({"tokens": _tokens(seed=5)})
    jprog = jscoring.scoring_program(jp, jcfg, fetches=ALL)
    tprog = tscoring.scoring_program(tp, tcfg, fetches=ALL, device="cpu")
    fn = tprog._fn
    before = tft.map_blocks(tprog, tf).to_arrays()["nll"]
    jprog.update_params(model=jp2)
    tprog.update_params(model=tp2)
    assert tprog._fn is fn  # the callable is never rebuilt
    jout, tout = tfs.map_blocks(jprog, jf), tft.map_blocks(tprog, tf)
    _assert_outputs_match(jout, tout)
    assert not np.allclose(before, tout.to_arrays()["nll"])
    bad = dict(tp2, embed=torch.zeros(3, 3))
    with pytest.raises(tft.program.ProgramError, match="must keep shape"):
        tprog.update_params(model=bad)
    # a failed update leaves the program unchanged
    np.testing.assert_array_equal(
        tft.map_blocks(tprog, tf).to_arrays()["nll"], tout.to_arrays()["nll"]
    )


def test_unknown_fetch_error_matches_jax():
    jcfg, tcfg, jp, tp = _models()
    with pytest.raises(ValueError) as je:
        jscoring.scoring_program(jp, jcfg, fetches=("nll", "bogus"))
    with pytest.raises(ValueError) as te:
        tscoring.scoring_program(tp, tcfg, fetches=("nll", "bogus"), device="cpu")
    assert str(je.value) == str(te.value)
