"""The port's program analysis (``analysis/``) against the JAX package's.

Verdict parity: every program of ``tests/test_analysis.py``'s corpus has a
torch twin here, and the port's program verdict and per-output verdicts
must equal the JAX package's on the same input specs, but for ``jnp.clip``
(``CALL_BOUNDARY``: a jitted call with literal bounds, which the JAX
classifier cannot read), whose difference is asserted as it stands.  The gate
(``analysis.rows_independent``: static answers, the probe fallback, the
counters, ``TFS_ANALYZE`` and ``TFS_ANALYZE_XCHECK``), the differential
fence against the exact-size probe, ``input_specs_for`` and ``check``'s
diagnostic codes (the same codes as the JAX package on the same frame)
are mirrored too.  A program that calls ``flash_attention`` classifies as
the JAX package's scoring program does, without a launch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import analysis as janalysis
from tensorframes_tpu.analysis import rowdep as jrowdep
from tensorframes_tpu.program import Program as JProgram
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import analysis, observability
from tensorframes_tpu_torch.analysis import rowdep
from tensorframes_tpu_torch.ops import segment_compile
from tensorframes_tpu_torch.parallel import flash
from tensorframes_tpu_torch.program import Program


def W(fn, **kw):
    return Program.wrap(fn, device="cpu", **kw)


def _jbranchy(x):
    if x.shape[0] < 4:
        return {"z": x + 1.0}
    return {"z": x * 2.0}


def _tbranchy(x):
    if x.shape[0] < 4:
        return {"z": x + 1.0}
    return {"z": x * 2.0}


def _jbranchy_cross(x):
    if x.shape[0] < 50:
        return {"z": x + 1.0}
    return {"z": x + x.sum()}


def _tbranchy_cross(x):
    if x.shape[0] < 50:
        return {"z": x + 1.0}
    return {"z": x + x.sum()}


# name -> (JAX program, torch twin, cell shape): tests/test_analysis.py's corpus
CORPUS = {
    "ew": (lambda x: {"z": x * 2.0 + 1.0}, lambda x: {"z": x * 2.0 + 1.0}, ()),
    "ew2": (lambda x, y: {"z": x * y}, lambda x, y: {"z": x * y}, ()),
    "tanh": (lambda x: {"z": jnp.tanh(x)}, lambda x: {"z": torch.tanh(x)}, ()),
    "where": (lambda x: {"z": jnp.where(x > 0, x, -x)},
              lambda x: {"z": torch.where(x > 0, x, -x)}, ()),
    "clip": (lambda x: {"z": jnp.clip(x, 0, 1)}, lambda x: {"z": torch.clamp(x, 0, 1)}, ()),
    "cast": (lambda x: {"z": x.astype(np.float32)}, lambda x: {"z": x.to(torch.float32)}, ()),
    "cellsum": (lambda x: {"z": x.sum(axis=1)}, lambda x: {"z": x.sum(1)}, (4,)),
    "cellrev": (lambda x: {"z": x[:, ::-1]}, lambda x: {"z": torch.flip(x, [1])}, (4,)),
    "reshape": (lambda x: {"z": x.reshape(x.shape[0], -1)},
                lambda x: {"z": x.reshape(x.shape[0], -1)}, (2, 3)),
    "mean": (lambda x: {"z": x / x.shape[0]}, lambda x: {"z": x / x.shape[0]}, ()),
    "blocksum": (lambda x: {"z": x - x.sum()}, lambda x: {"z": x - x.sum()}, ()),
    "sort": (lambda x: {"z": jnp.sort(x)}, lambda x: {"z": torch.sort(x).values}, ()),
    "cumsum": (lambda x: {"z": jnp.cumsum(x)}, lambda x: {"z": torch.cumsum(x, 0)}, ()),
    "rev0": (lambda x: {"z": x[::-1]}, lambda x: {"z": torch.flip(x, [0])}, ()),
    "zeros": (lambda x: {"z": jnp.zeros_like(x)}, lambda x: {"z": torch.zeros_like(x)}, ()),
    "matmul": (lambda x: {"z": x @ np.ones((3, 3))},
               lambda x: {"z": x @ torch.ones(3, 3, dtype=x.dtype, device=x.device)}, (3,)),
    "branchy": (_jbranchy, _tbranchy, ()),
    "branchy_cross": (_jbranchy_cross, _tbranchy_cross, ()),
    "multi": (lambda x: {"a": x + 1.0, "b": x - x.sum()},
              lambda x: {"a": x + 1.0, "b": x - x.sum()}, ()),
    # the lattice unit tests' programs
    "cellsum_keep": (lambda x: {"z": x - x.sum(axis=1, keepdims=True)},
                     lambda x: {"z": x - x.sum(1, keepdim=True)}, (4,)),
    "block_mean": (lambda x: {"z": x - x.mean(0)}, lambda x: {"z": x - x.mean(0)}, (3,)),
    "sq_cell_norm": (lambda x: {"z": jnp.sqrt((x * x).sum(axis=1))},
                     lambda x: {"z": torch.sqrt((x * x).sum(1))}, (4,)),
}


def _jprog(name):
    fn = CORPUS[name][0]
    return JProgram.wrap(fn)


def _tprog(name):
    return W(CORPUS[name][1])


def _specs(p, cell):
    return {n: (torch.float64, tuple(cell)) for n in p.input_names}


def _jspecs(p, cell):
    return {n: jax.ShapeDtypeStruct((2,) + tuple(cell), np.float64) for n in p.input_names}


# ``jnp.clip`` is a jitted function called with Python literals: the JAX
# classifier (and its probe) bail at that call boundary and read UNKNOWN.
# An ATen graph has no call boundaries, so ``torch.clamp`` reads what the
# elementwise op is: the one corpus program whose verdicts differ.
CALL_BOUNDARY = {"clip"}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_verdicts_equal_jax_on_the_corpus_twins(name):
    cell = CORPUS[name][2]
    jp, tp = _jprog(name), _tprog(name)
    j = jrowdep.classify(jp, _jspecs(jp, cell))
    t = rowdep.classify(tp, _specs(tp, cell))
    if name in CALL_BOUNDARY:
        assert j.verdict == rowdep.UNKNOWN and "call-boundary" in j.reason, j
        assert t.verdict == rowdep.ROW_INDEPENDENT, t
        return
    assert t.verdict == j.verdict, (t, j)
    assert t.outputs == j.outputs, (t, j)
    assert t.independent == j.independent


def test_params_are_const_class_as_jax():
    jp = JProgram.wrap(lambda x, w: {"z": x * w}, params={"w": np.float64(3.0)})
    tp = W(lambda x, w: {"z": x * w}, params={"w": np.float64(3.0)})
    assert rowdep.classify(tp, _specs(tp, ())).verdict == rowdep.ROW_INDEPENDENT
    assert jrowdep.classify(jp, _jspecs(jp, ())).verdict == rowdep.ROW_INDEPENDENT


def test_graphdef_program_classifies_as_jax():
    from tensorframes_tpu.graphdef import import_graphdef as jimport
    from tensorframes_tpu.graphdef.builder import GraphBuilder

    g = GraphBuilder()
    g.placeholder("x", "float64", [-1])
    g.const("three", np.float64(3.0))
    g.op("Add", "z", ["x", "three"])
    jp = jimport(g.to_bytes(), fetches=["z"])
    tp = tft.graphdef.import_graphdef(g.to_bytes(), fetches=["z"], device="cpu")
    j = jrowdep.classify(jp, _jspecs(jp, ()))
    t = rowdep.classify(tp, _specs(tp, ()))
    assert (t.verdict, t.outputs) == (j.verdict, j.outputs)


def test_classification_memoized():
    p = W(lambda x: {"z": x + 1.0})
    assert rowdep.classify(p, _specs(p, ())) is rowdep.classify(p, _specs(p, ()))


# -- the shared gate -----------------------------------------------------------


def test_classified_program_answers_without_probe(monkeypatch):
    monkeypatch.setenv("TFS_ANALYZE_XCHECK", "0")
    p = W(lambda x: {"z": x * 3.0})
    specs = _specs(p, ())
    rowdep.classify(p, specs)
    calls = []
    monkeypatch.setattr(segment_compile, "rows_independent_at",
                        lambda *a, **k: calls.append(a) or True)
    before = observability.counters()
    assert analysis.rows_independent(p, specs, (11, 16))
    assert analysis.rows_independent(p, specs, (23, 32))
    assert not calls, "a classified program must answer with 0 probes"
    delta = observability.counters_delta(before)
    assert delta["analysis_static_hits"] == 2
    assert delta["analysis_probe_fallbacks"] == 0


def test_gate_stops_at_the_first_cross_op(monkeypatch):
    """An op outside the whitelist on an input-derived value answers the
    gate from one run on meta tensors that stops at that op: no probe
    traces, later ops never run, and a full classification still reads
    JAX's verdict."""
    monkeypatch.setenv("TFS_ANALYZE_XCHECK", "0")
    w = torch.randn(4, 3, dtype=torch.float64)
    after = []

    def fn(x):
        y = torch.sort(x * 2.0, 0).values
        after.append(x.device.type)
        return {"z": y @ w}

    p = W(fn)
    specs = {"x": (torch.float64, (4,))}
    traced = []
    real = segment_compile._trace
    monkeypatch.setattr(segment_compile, "_trace",
                        lambda prog, sp, n: traced.append(n) or real(prog, sp, n))
    before = observability.counters()
    assert not analysis.rows_independent(p, specs, (5, 8))
    assert traced == [] and after == []
    assert observability.counters_delta(before)["analysis_static_hits"] == 1
    assert not analysis.rows_independent(p, specs, (6, 8))  # memoized
    assert traced == [] and after == []
    assert rowdep.classify(p, specs).verdict == rowdep.CROSS_ROW
    assert traced[0] == rowdep._ANALYZE_PROBES[0]


@pytest.mark.parametrize("fn", [
    lambda x: {"z": x.mean(1, keepdim=True) * x},
    lambda x: {"z": (x - x.var(1, keepdim=True)).clamp(0.0, 1.0)},
])
def test_gate_run_lets_whitelisted_and_decomposed_ops_through(monkeypatch, fn):
    """A row-wise mean or var (decomposed for the classifier) is not a
    crossing: the run finishes and the classifier answers, as JAX's."""
    monkeypatch.setenv("TFS_ANALYZE_XCHECK", "1")
    p = W(fn)
    specs = {"x": (torch.float64, (4,))}
    assert rowdep._first_cross(p, specs) == (True, None)
    assert analysis.rows_independent(p, specs, (5, 8))


def test_unknown_falls_back_to_probe(monkeypatch):
    monkeypatch.setenv("TFS_ANALYZE_XCHECK", "0")
    p = W(_tbranchy)
    before = observability.counters()
    assert analysis.rows_independent(p, _specs(p, ()), (8, 16))
    delta = observability.counters_delta(before)
    assert delta["analysis_probe_fallbacks"] == 1
    assert delta["analysis_static_hits"] == 0


def test_analyze_off_probes_as_before(monkeypatch):
    monkeypatch.setenv("TFS_ANALYZE", "0")
    p = W(lambda x: {"z": x + 1.0})
    before = observability.counters()
    assert analysis.rows_independent(p, _specs(p, ()), (3, 8))
    delta = observability.counters_delta(before)
    assert delta["analysis_static_hits"] == 0 and delta["analysis_probe_fallbacks"] == 0


def test_xcheck_raises_on_unsound_claim(monkeypatch):
    monkeypatch.setenv("TFS_ANALYZE_XCHECK", "1")
    p = W(lambda x: {"z": x + 1.0})
    specs = _specs(p, ())
    rowdep.classify(p, specs)
    monkeypatch.setattr(segment_compile, "cached_rows_independent", lambda *a, **k: False)
    with pytest.raises(rowdep.AnalysisXCheckError):
        analysis.rows_independent(p, specs, (3, 8))


SIZE_SETS = [(3, 8), (4, 16), (5, 97, 128), (7, 7)]


def test_differential_corpus_soundness():
    """No program where the classifier claims ROW_INDEPENDENT and the
    exact-size probe disproves it.  A definitive negative may meet a
    probe that proves independence only where the port's probe is the
    wider one (a product against a constant matrix: ``matmul``)."""
    failures = []
    for name in sorted(CORPUS):
        p = _tprog(name)
        specs = _specs(p, CORPUS[name][2])
        cls = rowdep.classify(p, specs)
        for sizes in SIZE_SETS:
            probed = segment_compile.rows_independent_at(p, specs, sizes)
            if cls.verdict == rowdep.ROW_INDEPENDENT and not probed:
                failures.append((name, sizes, "UNSOUND"))
            if cls.verdict in (rowdep.CROSS_ROW, rowdep.SIZE_DEPENDENT) and probed \
                    and name != "matmul":
                failures.append((name, sizes, "over-negative"))
    assert not failures, failures


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_through_the_gate_agrees_with_jax(monkeypatch, name):
    """Under ``TFS_ANALYZE_XCHECK=1`` the gate never raises, and its answer
    equals the JAX package's gate on every size set."""
    monkeypatch.setenv("TFS_ANALYZE_XCHECK", "1")
    cell = CORPUS[name][2]
    jp, tp = _jprog(name), _tprog(name)
    for sizes in SIZE_SETS:
        got = analysis.rows_independent(tp, _specs(tp, cell), sizes)
        want = janalysis.rows_independent(jp, _jspecs(jp, cell), sizes)
        if name in CALL_BOUNDARY:  # the JAX probe bails too: never padded there
            assert got and not want, (name, sizes)
            continue
        assert got == want, (name, sizes, got, want)


def test_bit_identity_analyzer_on_vs_off(monkeypatch):
    data = {"x": np.arange(11.0), "y": np.arange(11.0) * 0.5}

    def run_all():
        f = tft.TensorFrame.from_arrays(dict(data), num_blocks=3)
        m = tft.map_blocks(lambda x, y: {"z": x * y + 1.0}, f, device="cpu")
        r = tft.reduce_blocks(lambda x_input: {"x": x_input.sum(0)}, f, device="cpu")
        rr = tft.reduce_rows(lambda x_1, x_2: {"x": x_1 + x_2}, f, device="cpu")
        return {"map": m.to_arrays()["z"], "reduce": r["x"], "rr": rr["x"]}

    monkeypatch.setenv("TFS_ANALYZE", "0")
    off = run_all()
    monkeypatch.setenv("TFS_ANALYZE", "")
    on = run_all()
    for k in off:
        np.testing.assert_array_equal(off[k], on[k])


def test_oom_split_goes_through_the_classifier(monkeypatch):
    """The OOM split asks ``analysis.rows_independent``: a classified
    program splits with no probe trace."""
    calls = []
    monkeypatch.setattr(segment_compile, "rows_independent_at",
                        lambda *a, **k: calls.append(a) or False)
    monkeypatch.setenv("TFS_MIN_SPLIT_ROWS", "4")
    monkeypatch.setenv("TFS_BLOCK_RETRIES", "2")
    monkeypatch.setenv("TFS_FAULT_INJECT", "oom:block=0:minrows=20")
    f = tft.TensorFrame.from_arrays({"x": np.arange(80.0)}, num_blocks=4)
    out = tft.map_blocks(lambda x: {"y": x * 2.0}, f, device="cpu")
    np.testing.assert_array_equal(out.to_arrays()["y"], np.arange(80.0) * 2.0)
    assert not calls


# -- input_specs_for ------------------------------------------------------------


def test_input_specs_for_column_infos_and_pairs():
    f = tft.TensorFrame.from_arrays({"x": np.arange(12.0).reshape(6, 2)}, num_blocks=2)
    p = W(lambda x: {"z": x + 1.0})
    assert analysis.input_specs_for(p, {"x": f.schema["x"]}) == {"x": (torch.float64, (2,))}
    assert analysis.input_specs_for(p, {"x": (np.zeros((5, 3)), np.float32)}) == {
        "x": (torch.float32, (3,))}
    assert analysis.input_specs_for(p, {}) is None
    rag = tft.TensorFrame.from_arrays({"x": [np.zeros((2,)), np.zeros((3,))]})
    assert analysis.input_specs_for(p, {"x": rag.schema["x"]}) is None


# -- check: the same codes as the JAX package -------------------------------------


def _frames():
    cols = {"x": np.arange(10.0), "y": np.arange(20.0).reshape(10, 2)}
    return (tfs.TensorFrame.from_arrays(cols, num_blocks=2),
            tft.TensorFrame.from_arrays(cols, num_blocks=2))


def _codes(diags):
    return [d.code for d in diags]


def _graph(kind):
    from tensorframes_tpu.graphdef.builder import GraphBuilder

    g = GraphBuilder()
    if kind == "unsupported":
        g.placeholder("x", "float64", [-1])
        g.op("FrobnicateV2", "z", ["x"])
    elif kind == "decode":
        g.placeholder("contents", "binary", [])
        g.op("DecodeJpeg", "decoded", ["contents"], channels=3)
        g.op("Neg", "neg", ["contents"])
    else:
        g.placeholder("x", "float64", [-1])
        g.const("three", np.float64(3.0))
        g.op("Add", "z", ["x", "three"])
    return g.to_bytes()


CHECKS = {
    "clean": (lambda x: {"z": x + 1.0}, lambda x: {"z": x + 1.0}, "map_blocks", {}),
    "TFS101": (lambda x: x, lambda x: x, "frobnicate", {}),
    "TFS102": (lambda *a: {"z": a[0]}, lambda *a: {"z": a[0]}, "map_blocks", {}),
    "TFS103": (lambda q: {"z": q + 1.0}, lambda q: {"z": q + 1.0}, "map_blocks", {}),
    "TFS106": (lambda x_1: {"x": x_1}, lambda x_1: {"x": x_1}, "reduce_rows", {}),
    "TFS108": (lambda a: {"x": a.sum()}, lambda a: {"x": a.sum()}, "reduce_blocks", {}),
    "TFS109": (lambda x_input: {"x": x_input}, lambda x_input: {"x": x_input},
               "reduce_blocks", {}),
    "TFS111": (lambda x: {"z": x @ np.ones((3, 3))},
               lambda x: {"z": x @ torch.ones(3, 3, dtype=x.dtype, device=x.device)},
               "map_blocks", {}),
    "TFS112": (lambda x: {"z": x + 1.0}, lambda x: {"z": x + 1.0}, "map_blocks",
               {"host_stage": {"nope": lambda cells: cells}}),
    "TFS120": ("unsupported", "unsupported", "map_blocks", {"fetches": ["z"]}),
    "TFS121": ("decode", "decode", "map_rows", {"fetches": ["decoded", "neg"]}),
    "TFS123": ("add3", "add3", "map_blocks", {"fetches": ["nope"]}),
    "TFS130": (lambda x: {"z": x - x.sum()}, lambda x: {"z": x - x.sum()}, "map_blocks", {}),
    "TFS131": (_jbranchy, _tbranchy, "map_blocks", {}),
    "agg_key": (lambda x_input: {"x": x_input.sum(0)}, lambda x_input: {"x": x_input.sum(0)},
                "aggregate", {"keys": ["nope"]}),
}


@pytest.mark.parametrize("case", sorted(CHECKS))
def test_check_codes_equal_jax(case):
    jfn, tfn, verb, kw = CHECKS[case]
    if isinstance(jfn, str):
        jfn = tfn = _graph(jfn)
    jf, tf = _frames()
    j = tfs.check(jf, jfn, verb, **kw)
    t = tft.check(tf, tfn, verb, device="cpu", **kw)
    assert _codes(t) == _codes(j), (t, j)
    assert [d.severity for d in t] == [d.severity for d in j]
    if case.startswith("TFS10") or case == "agg_key":
        assert [d.summary for d in t] == [d.summary for d in j]


def test_check_TFS107_and_TFS110_equal_jax():
    jf, tf = _frames()
    jp = JProgram.wrap(lambda x_1, x_2: {"x": x_1 + x_2}, feed_dict={"x_1": "x", "x_2": "y"})
    tp = W(lambda x_1, x_2: {"x": x_1 + x_2}, feed_dict={"x_1": "x", "x_2": "y"})
    assert _codes(tft.check(tf, tp, "reduce_rows")) == _codes(tfs.check(jf, jp, "reduce_rows"))
    jp = JProgram.wrap(lambda y: {"z": y * 1.0}, fetches=["z"]).with_shape_hints({"z": [-1, 5]})
    tp = W(lambda y: {"z": y * 1.0}, fetches=["z"]).with_shape_hints({"z": [-1, 5]})
    assert _codes(tft.check(tf, tp, "map_blocks")) == _codes(tfs.check(jf, jp, "map_blocks"))
    assert _codes(tft.check(tf, tp, "map_blocks")) == ["TFS110"]


def test_check_codes_registry_equals_jax():
    from tensorframes_tpu.analysis import contracts as jcontracts
    from tensorframes_tpu_torch.analysis import contracts

    assert contracts.CODES == jcontracts.CODES
    assert analysis.CODES is contracts.CODES


def test_check_relational_waits_for_item_11():
    """The relational contracts have landed with the relational verbs
    (item 11): ``check_relational`` and ``check(..., "shuffle"|"join")``
    give the JAX package's TFS14x diagnostics."""
    from tensorframes_tpu.analysis import contracts as jcontracts

    jtf, tf = _frames()
    for verb, keys in (("join", ["x"]), ("join", ["nope"]), ("shuffle", ["x"]),
                       ("shuffle", ["nope"]), ("join", [])):
        right = tf if verb == "join" else None
        jright = jtf if verb == "join" else None
        got = analysis.check_relational(tf, verb, keys=keys, right=right)
        want = jcontracts.check_relational(jtf, verb, keys=keys, right=jright)
        assert [(d.code, d.severity, d.location) for d in got] == [
            (d.code, d.severity, d.location) for d in want]
    assert [d.code for d in tft.check(tf, None, "shuffle", keys=["nope"])] == ["TFS140"]


# -- the flash kernel inside a traced program ---------------------------------------


def test_flash_program_classifies_as_jax_without_a_launch():
    """The scoring program calls ``flash_attention``; traced on ``meta``
    tensors it runs the shape-only product chain (``_attention_meta``),
    launches nothing, and reads
    CROSS_ROW, as the JAX package's scoring program does (its embedding
    gather and its attention kernel are outside the whitelist)."""
    from tensorframes_tpu.models import scoring as jscoring
    from tensorframes_tpu.models import transformer as jtfm
    from tensorframes_tpu_torch.models import convert
    from tensorframes_tpu_torch.models import scoring as tscoring

    fields = dict(vocab_size=32, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
                  d_ff=64, max_seq=16, dtype=jnp.float32)
    jcfg = jtfm.TransformerConfig(**fields)
    tcfg = dataclasses.replace(
        convert.config_from_dict(dataclasses.asdict(jcfg)), attn_impl="flash")
    jp = jtfm.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jprog = jscoring.scoring_program(jp, jcfg)
    tprog = tscoring.scoring_program(tp, tcfg, device="cpu")
    before = (flash.launches, dict(flash.kernel_launches))
    j = jrowdep.classify(jprog, {"tokens": jax.ShapeDtypeStruct((2, 8), np.int32)})
    t = rowdep.classify(tprog, {"tokens": (torch.int32, (8,))})
    assert t.verdict == j.verdict == rowdep.CROSS_ROW, (t, j)
    assert t.outputs == j.outputs
    assert (flash.launches, dict(flash.kernel_launches)) == before
    specs = {"tokens": (torch.int32, (8,))}
    assert not analysis.rows_independent(tprog, specs, (8, 16))


def test_bridge_check_rpc():
    """The ungated ``check`` RPC on the port's server: clean, a missing
    input (TFS103, as JAX's server answers), and pure on repeat."""
    from tensorframes_tpu.bridge import BridgeClient as JBridgeClient
    from tensorframes_tpu.bridge import serve as jserve
    from tensorframes_tpu_torch.bridge import BridgeClient, serve
    from tensorframes_tpu_torch.graphdef.builder import GraphBuilder

    g = GraphBuilder()
    g.placeholder("x", "float64", [-1])
    g.const("three", np.float64(3.0))
    g.op("Add", "z", ["x", "three"])
    add3 = g.to_bytes()
    srv, jsrv = serve(device="cpu"), jserve()
    try:
        bads = []
        for s, cls in ((srv, BridgeClient), (jsrv, JBridgeClient)):
            with cls(*s.address, timeout_s=60.0) as c:
                rf = c.create_frame({"x": np.arange(8.0)}, num_blocks=2).analyze()
                assert rf.check("map_blocks", add3, fetches=["z"]) == []
                bad = rf.check("map_blocks", add3, fetches=["z"], inputs={"x": "missing"})
                assert [d["code"] for d in bad] == ["TFS103"]
                assert bad[0]["severity"] == "error"
                assert rf.check("map_blocks", add3, fetches=["z"],
                                inputs={"x": "missing"}) == bad
                bads.append(bad)
        assert [(d["code"], d["severity"]) for d in bads[0]] == [
            (d["code"], d["severity"]) for d in bads[1]]
    finally:
        srv.close(drain_s=1.0)
        jsrv.close(drain_s=1.0)
