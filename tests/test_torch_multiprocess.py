"""The port's multi-process runtime, mirroring the process-group cases of
``tests/test_multiprocess.py`` (the train-step cases wait for ROADMAP.md
Queue 1 item 13b): two real OS processes, each with four injected CPU
devices, form one ``gloo`` group through ``multihost.initialize``; a frame
is assembled from per-process rows and a cross-process ``reduce_blocks``
runs over the 8 global devices.  The rows are JAX's worker's
(``tests/_mp_worker.make_data``); the sum is held to the host sum at
``rel=1e-6`` (f32 rows), as JAX's is.  The port's own cases: ranks on one
host split its CUDA cards for the default data mesh."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_mp_worker.py")
sys.path.insert(0, HERE)
import _mp_worker  # noqa: E402 - the JAX workers' data
import _torch_mp_worker  # noqa: E402
from tensorframes_tpu_torch.parallel import multihost  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp")
    out = str(tmp / "result.json")
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    # output goes to files, not pipes: the workers can log freely
    logs = [open(tmp / f"worker{pid}.log", "w+b") for pid in (0, 1)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, str(pid), out],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        for pid, log in zip((0, 1), logs)
    ]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read().decode(errors="replace"))
        log.close()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, f"worker failed:\n{text[-3000:]}"
    with open(out) as f:
        return json.load(f)


def test_two_processes_form_one_group(mp_results):
    assert mp_results["process_count"] == 2
    assert mp_results["global_devices"] == 8
    assert mp_results["local_devices"] == 4
    assert mp_results["mesh_size"] == 8


def test_cross_process_reduce_matches_host(mp_results):
    all_x, _ = _mp_worker.make_data()
    np.testing.assert_array_equal(_torch_mp_worker.make_data(), all_x)
    for key in ("reduce_sum", "per_block_sum"):
        assert mp_results[key] == pytest.approx(float(all_x.sum()), rel=1e-6)


def test_cross_process_map_stays_process_local(mp_results):
    all_x, _ = _mp_worker.make_data()
    assert mp_results["doubled_rows"] == [0, 8]  # process 0's own rows
    assert mp_results["doubled_sum"] == pytest.approx(2 * float(all_x.sum()), rel=1e-6)
    assert mp_results["foreign_read_raises"] is True


def test_ranks_on_one_host_split_its_cards(mp_results):
    """Both ranks run on this host and see the same eight cards: the
    default data mesh gives each its own half, never the same card."""
    assert mp_results["host_rank"] == [0, 2]
    assert mp_results["card_split"] == [
        [f"cuda:{i}" for i in range(4)],
        [f"cuda:{i}" for i in range(4, 8)],
    ]
    assert mp_results["card_mesh_size"] == 8


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_more_ranks_than_cards(backend):
    """Three ranks on a host of two cards: ``gloo`` ranks share the cards
    round robin; NCCL takes one rank a card, so ``nccl`` refuses."""
    cards = [torch.device("cuda", i) for i in range(2)]
    if backend == "nccl":
        with pytest.raises(ValueError, match="one rank a card"):
            multihost.cards_of_rank(cards, 2, 3, backend)
        return
    assert [multihost.cards_of_rank(cards, r, 3, backend) for r in range(3)] == [
        [cards[0]], [cards[1]], [cards[0]]]
