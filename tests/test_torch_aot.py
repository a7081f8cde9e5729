"""Program artifacts, ahead-of-time export, warmup and the compile cache:
the twins of ``tests/test_verbs.py:519-560`` (serialize round trips) and
``tests/test_bucketing.py:305-430`` (``warmup`` bucket mirroring,
``aot_compile`` memo and fingerprint, the ``cached_jit`` LRU,
``Pipeline.warmup``), plus ``compile_cache`` and the planner's calibration
table under the cache directory.

Where the JAX package lowers to StableHLO, the port exports with
``torch.export``: the artifacts differ by design (ROADMAP.md Queue 3), so
the twins hold the port's results to JAX's on the same inputs, and the
fingerprint and bucket counts to JAX's.  JAX's
``test_persistent_cache_hit_after_cache_clear`` reads a compiled
executable back from disk; the port's one compile is ``nvcc``, which
this machine lacks, so its real check is ``chip_smoke.py``'s planner phase
(leg f: a second process with the same ``TFS_COMPILE_CACHE`` runs no
``nvcc``), and here a stand-in compiler holds the bookkeeping."""

import ctypes
import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
from tensorframes_tpu import compile_cache as jcompile_cache
from tensorframes_tpu import dtypes as jdt
from tensorframes_tpu.program import deserialize_program as jdeserialize
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import _build, compile_cache, dtypes, observability as obs
from tensorframes_tpu_torch.models import scoring, transformer as tfm
from tensorframes_tpu_torch.ops import planner
from tensorframes_tpu_torch.program import deserialize_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_dir(tmp_path):
    path = str(tmp_path / "cc")
    assert compile_cache.configure(path)
    yield path
    compile_cache.deconfigure()


def _frame(data, blocks=1):
    return tft.analyze(tft.TensorFrame.from_arrays(data, num_blocks=blocks))


def _uneven_frame(rows=1030, blocks=4, d=8, seed=0, mod=tft):
    rng = np.random.RandomState(seed)
    f = mod.TensorFrame.from_arrays(
        {"x": rng.rand(rows, d).astype(np.float32), "w": rng.rand(rows).astype(np.float32)},
        num_blocks=blocks,
    )
    assert len(set(f.block_sizes)) > 1
    return f


# ---------------------------------------------------------------------------
# serialize / deserialize_program
# ---------------------------------------------------------------------------


def test_program_serialize_round_trip():
    """Program -> artifact -> Program, params frozen in, one symbolic rows
    dim serving any block size; JAX's header, JAX's values."""
    p = tft.Program.wrap(lambda x, scale: {"z": x * scale + 1.0},
                         params={"scale": np.float64(3.0)}, device="cpu")
    data = p.serialize({"x": (dtypes.by_name("float64"), (-1, 2))})
    assert isinstance(data, bytes) and len(data) > 100
    header = json.loads(data[: data.index(b"\x00")].decode())
    assert header == {"format": "tfs-program-v1", "inputs": ["x"], "fetches": ["z"], "feed": {}}
    jp = tfs.Program.wrap(lambda x, scale: {"z": x * scale + 1.0},
                          params={"scale": np.float64(3.0)})
    jdata = jp.serialize({"x": (jdt.by_name("float64"), (-1, 2))})
    assert json.loads(jdata[: jdata.index(b"\x00")].decode()) == header
    back = deserialize_program(data, device="cpu")
    jback = jdeserialize(jdata)
    assert back.input_names == ["x"]  # params are frozen into the artifact
    for n in (3, 5):  # symbolic rows: no per-size re-export
        x = np.arange(float(n * 2)).reshape(n, 2)
        out = np.asarray(tft.map_blocks(back, _frame({"x": x})).to_arrays()["z"])
        np.testing.assert_array_equal(out, x * 3.0 + 1.0)
        jout = tfs.map_blocks(jback, tfs.analyze(tfs.TensorFrame.from_arrays({"x": x})))
        np.testing.assert_array_equal(out, np.asarray(jout.column("z").data))


def test_program_serialize_reduce_blocks():
    p = tft.Program.wrap(lambda x_input: {"x": x_input.sum(0)}, device="cpu")
    back = deserialize_program(p.serialize({"x_input": (dtypes.by_name("float64"), (-1,))}),
                               device="cpu")
    got = tft.reduce_blocks(back, _frame({"x": np.arange(10.0)}, blocks=3))
    assert got["x"] == pytest.approx(45.0)


def test_deserialize_rejects_garbage():
    with pytest.raises((tft.ProgramError, ValueError)):
        deserialize_program(b'{"format": "nope"}\x00junk', device="cpu")
    with pytest.raises(ValueError):
        deserialize_program(b"no header at all", device="cpu")


def test_program_serialize_preserves_feed_dict():
    p = tft.Program.wrap(lambda x: {"z": x + 1.0}, feed_dict={"x": "colA"}, device="cpu")
    back = deserialize_program(p.serialize({"x": (dtypes.by_name("float64"), (-1,))}),
                               device="cpu")
    assert back.column_for_input("x") == "colA"
    out = tft.map_blocks(back, _frame({"colA": np.arange(4.0)}))
    np.testing.assert_allclose(np.asarray(out.to_arrays()["z"]), np.arange(4.0) + 1.0)


def test_serialized_scoring_program_keeps_the_flash_op():
    """An exported scoring program calls ``tensorframes_torch::flash_fwd``
    (the forward kernel on the card, its plain version here): its nll
    equals the live program's bit for bit at two block sizes, and the
    roofline of the deserialized program still counts attention."""
    from tensorframes_tpu_torch import roofline

    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=64, max_seq=16, dtype=torch.float32, attn_impl="flash")
    params = tfm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    live = scoring.scoring_program(params, cfg, fetches=("nll",), device="cpu")
    data = live.serialize({"tokens": (dtypes.by_name("int32"), (-1, 16))})
    assert b"flash_fwd" in data
    back = deserialize_program(data, device="cpu")
    tok = np.random.RandomState(0).randint(0, 64, (10, 16)).astype(np.int32)
    for blocks in (2, 5):
        fr = tft.TensorFrame.from_arrays({"tokens": tok}, num_blocks=blocks)
        a = np.asarray(tft.map_blocks(live, fr).to_arrays()["nll"])
        b = np.asarray(tft.map_blocks(back, fr).to_arrays()["nll"])
        np.testing.assert_array_equal(a, b)
    kw = dict(peak_flops=1e12, peak_bytes_per_s=1e11)
    block = {"tokens": torch.as_tensor(tok[:2])}
    want = roofline.roofline(live, block, **kw)
    got = roofline.roofline(back, block, **kw)
    assert [o for o in got.ops if o.kind == "flash_fwd"], [o.kind for o in got.ops]
    assert sum(o.flops for o in got.ops if o.kind == "flash_fwd") == sum(
        o.flops for o in want.ops if o.kind == "attention")


# ---------------------------------------------------------------------------
# the kernel libraries under the compile cache
# ---------------------------------------------------------------------------


def test_kernel_libraries_build_and_load_under_the_compile_cache(tmp_path, monkeypatch, cache_dir):
    """With ``TFS_COMPILE_CACHE`` the libraries build into ``<dir>/kernels``;
    a fresh process (here: the loaded-library memo cleared) loads them
    without nvcc.  A stand-in compiler writes the library file; the real
    build is checked on the card (chip_smoke.py, the planner phase's leg f)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "cuda_bin", lambda tool: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    assert _build.library_path("flash_fwd").parent == __import__("pathlib").Path(cache_dir) / "kernels"
    c0 = obs.counters()
    _build.load("flash_fwd")
    d = obs.counters_delta(c0)
    assert (d["backend_compiles"], d["persistent_cache_misses"]) == (1, 1)
    assert _build.library_path("flash_fwd").exists()
    monkeypatch.setattr(_build, "_loaded", {})  # a second process
    c0 = obs.counters()
    _build.load("flash_fwd")
    d = obs.counters_delta(c0)
    assert (d["backend_compiles"], d["persistent_cache_hits"]) == (0, 1)


def test_compile_cache_configure_and_deconfigure(tmp_path, monkeypatch):
    monkeypatch.delenv("TFS_COMPILE_CACHE", raising=False)
    compile_cache.deconfigure()
    assert not compile_cache.configure() and compile_cache.cache_dir() is None
    assert compile_cache.subdir("kernels") is None
    assert _build.build_dir() == _build.BUILD_DIR
    monkeypatch.setenv("TFS_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.configure()
    assert compile_cache.cache_dir() == str(tmp_path / "env") and (tmp_path / "env").is_dir()
    assert compile_cache.configure(str(tmp_path / "other"))  # re-pointing reconfigures
    assert compile_cache.subdir("programs") == str(tmp_path / "other" / "programs")
    compile_cache.deconfigure()
    assert compile_cache.cache_dir() is None
    # both packages take the knob the same way: an unset path is a no-op
    monkeypatch.delenv("TFS_COMPILE_CACHE")
    assert jcompile_cache.configure() == compile_cache.configure() is False


def test_package_import_honours_tfs_compile_cache(tmp_path):
    env = dict(os.environ, TFS_COMPILE_CACHE=str(tmp_path / "imp"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import tensorframes_tpu_torch as t, tensorframes_tpu_torch._build as b; "
         "print(t.compile_cache.cache_dir()); print(b.build_dir())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300, check=True,
    )
    lines = out.stdout.split()
    assert lines == [str(tmp_path / "imp"), str(tmp_path / "imp" / "kernels")]


def test_calibration_persists_under_the_cache_dir(monkeypatch, cache_dir):
    """With ``TFS_PLAN_CALIBRATE`` and the cache configured, measurements
    persist as ``<dir>/tfs-calibration-v1.json`` under a stable
    fingerprint; after a "restart" the persisted table merges back."""
    monkeypatch.setenv("TFS_PLAN_CALIBRATE", "1")
    planner.reset_calibration(persisted=True)
    try:
        frame = tft.TensorFrame.from_arrays({"x": np.arange(64.0)}, num_blocks=4)

        def chain():
            l1 = tft.map_blocks(lambda x: {"y": x * 2.0}, frame.lazy(), fetches=["y"],
                                device="cpu")
            return tft.map_blocks(lambda y: {"z": y + 1.0}, l1, fetches=["z"], device="cpu")

        z1 = np.asarray(chain().to_arrays()["z"])
        path = planner._calib_persist_path(cache_dir)
        assert path == os.path.join(cache_dir, "tfs-calibration-v1.json")
        doc = json.loads(open(path).read())
        assert doc["format"] == "tfs-calibration-v1"
        (fp, rec), = doc["entries"].items()
        assert "serial" in rec
        rec.setdefault("pool", 10.0 ** 12)
        open(path, "w").write(json.dumps(doc))
        planner.reset_calibration(persisted=True)
        with planner._CALIBRATION_LOCK:
            assert planner._calib_persist_table()[fp]["pool"] == 10.0 ** 12
        z2 = np.asarray(chain().to_arrays()["z"])
        np.testing.assert_array_equal(z1, z2)
        doc2 = json.loads(open(path).read())
        assert set(doc2["entries"]) == {fp}
        assert doc2["entries"][fp]["pool"] == 10.0 ** 12 and doc2["entries"][fp]["serial"] > 0
    finally:
        planner.reset_calibration(persisted=True)


# ---------------------------------------------------------------------------
# warmup + aot_compile
# ---------------------------------------------------------------------------


def test_warmup_aot_compiles_bucket_signature(cache_dir):
    frame = _uneven_frame(rows=301, blocks=3, d=4, seed=17)
    prog = tft.Program.wrap(lambda x: {"y": x * 4.0}, fetches=["y"], device="cpu")
    fps = tft.warmup(prog, frame)
    assert len(fps) == 1  # every block size rounds to one bucket
    jprog = tfs.Program.wrap(lambda x: {"y": x * 4.0}, fetches=["y"])
    assert len(tfs.warmup(jprog, _uneven_frame(rows=301, blocks=3, d=4, seed=17, mod=tfs))) == 1
    # the same source in a "fresh replica": the same fingerprint, and the
    # exported program is in the cache under it
    prog2 = tft.Program.wrap(lambda x: {"y": x * 4.0}, fetches=["y"], device="cpu")
    assert tft.warmup(prog2, frame) == fps
    assert os.path.exists(os.path.join(cache_dir, "programs", f"{fps[0]}.pt2"))
    assert prog.entry_warm(False)  # primed: the planner's "warm"


def test_warmup_primes_without_tracing_and_matches_the_verbs():
    frame = _uneven_frame(rows=101, blocks=2, d=4, seed=29)
    prog = tft.Program.wrap(lambda x: {"y": x * 2.0}, fetches=["y"], device="cpu")
    c0 = obs.counters()
    fps = tft.warmup(prog, frame)
    d = obs.counters_delta(c0)
    assert d["program_traces"] == 0 and d["h2d_bytes_staged"] == 0, d
    (fn,) = [v for k, v in prog._derived.items() if k[0] == ("aot", False)]
    assert fn.fingerprint == fps[0]
    n = fn.signature[0][1][0]
    x = torch.as_tensor(np.asarray(frame.column("x").data)[:n])
    if x.shape[0] < n:
        x = torch.cat([x, x[-1:].expand(n - x.shape[0], -1)])
    np.testing.assert_array_equal(fn({"x": x})["y"].numpy(), (x * 2.0).numpy())


def test_aot_executable_runs_and_is_lru_cached():
    prog = tft.Program.wrap(lambda x: {"y": x * 2.0}, fetches=["y"], device="cpu")
    specs = {"x": (tft.scalar_type("float32"), (8, 2))}
    fn = prog.aot_compile(specs)
    out = fn({"x": torch.ones((8, 2))})
    np.testing.assert_array_equal(out["y"].numpy(), np.full((8, 2), 2.0))
    assert prog.aot_compile(specs) is fn  # memoized
    assert isinstance(fn.fingerprint, str) and len(fn.fingerprint) == 16
    assert fn.signature == (("x", (8, 2), "torch.float32"),)
    jfn = tfs.Program.wrap(lambda x: {"y": x * 2.0}, fetches=["y"]).aot_compile(
        {"x": (tfs.scalar_type("float32"), (8, 2))})
    assert len(jfn.fingerprint) == len(fn.fingerprint)
    with pytest.raises(tft.ProgramError, match="static shape"):
        prog.aot_compile({"x": (tft.scalar_type("float32"), (-1, 2))})


def test_aot_callable_reads_live_params_and_rows_level():
    prog = tft.Program.wrap(lambda x, w: {"y": x * w}, fetches=["y"],
                            params={"w": np.float32(2.0)}, device="cpu")
    fn = prog.aot_compile({"x": (tft.scalar_type("float32"), (4,))})
    v0 = prog._params_version
    prog.update_params(w=np.float32(5.0))
    assert prog._params_version == v0 + 1
    np.testing.assert_array_equal(fn({"x": torch.ones(4)})["y"].numpy(), np.full(4, 5.0))
    rows = tft.Program.wrap(lambda x: {"r": x.sum() + x[0]}, fetches=["r"], device="cpu")
    rfn = rows.aot_compile({"x": (tft.scalar_type("float32"), (6, 3))}, rows_level=True)
    x = torch.arange(18.0).reshape(6, 3)
    np.testing.assert_array_equal(rfn({"x": x})["r"].numpy(), (x.sum(1) + x[:, 0]).numpy())
    assert rfn.fingerprint != rows.aot_compile({"x": (tft.scalar_type("float32"), (6, 3))}
                                              ).fingerprint


def test_aot_fingerprint_is_the_same_across_processes():
    code = (
        "import tensorframes_tpu_torch as t\n"
        "p = t.Program.wrap(lambda x: {'y': x * 4.0 + 1.0}, fetches=['y'], device='cpu')\n"
        "print(p.aot_compile({'x': (t.scalar_type('float32'), (16, 3))}).fingerprint)\n"
    )
    there = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=300, check=True).stdout.strip()
    here = tft.Program.wrap(lambda x: {"y": x * 4.0 + 1.0}, fetches=["y"], device="cpu")
    assert there == here.aot_compile({"x": (tft.scalar_type("float32"), (16, 3))}).fingerprint


def test_pipeline_warmup_primes_the_chain():
    """``Pipeline.warmup`` checks the chain on meta tensors (the JAX package
    compiles it); the run after it traces nothing and equals JAX's."""
    rng = np.random.RandomState(23)
    x = rng.rand(64, 4).astype(np.float32)
    frame = tft.TensorFrame.from_arrays({"x": x}, num_blocks=2)

    def chain(mod, fr, **kw):
        return (mod.pipeline(fr, **kw)
                .map_blocks(lambda x: {"g": x * 2.0}, trim=True)
                .reduce_blocks(lambda g_input: {"g": g_input.sum(axis=0)}))

    assert isinstance(chain(tft, frame, device="cpu").warmup(), tft.Pipeline)
    c0 = obs.counters()
    out = chain(tft, frame, device="cpu").run()
    assert obs.counters_delta(c0)["program_traces"] == 0
    jout = chain(tfs, tfs.TensorFrame.from_arrays({"x": x}, num_blocks=2)).run()
    np.testing.assert_allclose(out["g"].numpy(), np.asarray(jout["g"]), rtol=1e-6)


def test_pipeline_over_a_lazy_frame_materialises_it_first():
    frame = tft.TensorFrame.from_arrays({"x": np.arange(8.0)}, num_blocks=2)
    lz = tft.map_blocks(lambda x: {"y": x + 1.0}, frame.lazy(), device="cpu")
    out = tft.pipeline(lz, device="cpu").reduce_blocks(
        lambda y_input: {"y": y_input.sum(0)}).collect()
    assert lz.is_materialized
    assert float(out["y"]) == pytest.approx(np.arange(8.0).sum() + 8.0)


# ---------------------------------------------------------------------------
# Program.cached_jit LRU
# ---------------------------------------------------------------------------


def test_cached_jit_is_lru_not_fifo():
    prog = tft.Program.wrap(lambda x: {"y": x}, fetches=["y"], device="cpu")
    hot = prog.cached_jit(("hot",), lambda: lambda ins, params: ins)
    assert tft.Program._DERIVED_CAP == tfs.Program._DERIVED_CAP
    for i in range(2 * tft.Program._DERIVED_CAP):
        assert prog.cached_jit(("hot",), lambda: pytest.fail("hot rebuilt")) is hot
        prog.cached_jit(("one-off", i), lambda: lambda ins, params: ins)
    assert prog.cached_jit(("hot",), lambda: pytest.fail("hot evicted")) is hot
    assert len(prog._derived) == tft.Program._DERIVED_CAP


def test_warmup_mirrors_bucket_plan_for_cross_row_programs():
    """A cross-row program keeps exact per-size shapes (one fingerprint a
    distinct block size); a row-independent one is bucketed: JAX's
    counts."""
    frame = _uneven_frame(rows=101, blocks=2, d=4, seed=29)
    jframe = _uneven_frame(rows=101, blocks=2, d=4, seed=29, mod=tfs)
    prog = tft.Program.wrap(lambda x: {"y": x - x.mean(dim=0)}, fetches=["y"], device="cpu")
    fps = tft.warmup(prog, frame)
    jfps = tfs.warmup(tfs.Program.wrap(lambda x: {"y": x - x.mean(axis=0)}, fetches=["y"]),
                      jframe)
    assert len(fps) == len(jfps) == len(set(frame.block_sizes)) == 2
    prog2 = tft.Program.wrap(lambda x: {"y": x * 2.0}, fetches=["y"], device="cpu")
    assert len(tft.warmup(prog2, frame)) == 1 == len(
        tfs.warmup(tfs.Program.wrap(lambda x: {"y": x * 2.0}, fetches=["y"]), jframe))


def test_warmup_probes_host_stage_cell_shape():
    stage = {"x": lambda cells: np.stack([np.full(3, c) for c in cells])}
    fps = tft.warmup(lambda x: {"y": x.sum(dim=1)}, tft.TensorFrame.from_arrays(
        {"x": np.arange(12, dtype=np.float32)}, num_blocks=2), fetches=["y"], host_stage=stage,
        device="cpu")
    jfps = tfs.warmup(lambda x: {"y": x.sum(axis=1)}, tfs.TensorFrame.from_arrays(
        {"x": np.arange(12, dtype=np.float32)}, num_blocks=2), fetches=["y"], host_stage=stage)
    assert len(fps) == len(jfps) >= 1


def test_warmup_refuses_ragged_map_rows():
    frame = tft.TensorFrame.from_rows([{"x": np.ones(2)}, {"x": np.ones(3)}])
    with pytest.raises(tft.ValidationError, match="ragged"):
        tft.warmup(lambda x: {"y": x.sum()}, frame, rows_level=True, fetches=["y"],
                   device="cpu")
