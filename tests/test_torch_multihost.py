"""The process-group transport of the port's distributed sort
(radx_tpu_torch/parallel/multihost.py): 2 and 4 gloo ranks as processes on
the CPU (``python -m radx_tpu_torch.parallel._worker``), each rank one
shard, the exchange waves and collectives crossing process boundaries.
The rows that ``allgather_result`` assembles must equal the in-process
mesh's rows bit for bit.  Every process gets a free port and a timeout."""

import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from radx_tpu_torch.parallel import Mesh, dist_sort, multihost
from radx_tpu_torch.parallel._worker import make_input

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_RANK = 2048

torch.set_num_threads(1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(n_ranks, out, *flags):
    address = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "radx_tpu_torch.parallel._worker", address,
           str(n_ranks)]
    procs = [subprocess.Popen(
        [*cmd, str(r), str(PER_RANK * n_ranks), "--device", "cpu", "--out",
         str(out), *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for r in range(n_ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
        assert f"WORKER_OK rank={r}" in text, text[-4000:]


@pytest.mark.parametrize("n_ranks,exchange,pairs", [
    (2, "flat", False), (4, "flat", False), (4, "hier", False),
    (2, "flat", True), (4, "hier", True)])
def test_gloo_ranks_match_in_process_mesh(tmp_path, n_ranks, exchange, pairs):
    out = tmp_path / "rows.npz"
    flags = ["--exchange", exchange] + (["--pairs"] if pairs else [])
    _run_ranks(n_ranks, out, *flags)
    got = np.load(out)
    keys, vals = make_input(PER_RANK * n_ranks, pairs)
    mesh = Mesh([torch.device("cpu")] * n_ranks)
    if pairs:
        k, v, valid, overflow = dist_sort.sort_pairs_sharded(
            keys, vals, mesh, stable=True, exchange=exchange)
        want = [k, v]
    else:
        k, valid, overflow = dist_sort.sort_sharded(keys, mesh,
                                                    exchange=exchange)
        want = [k]
    for i, w in enumerate(want):
        g = got[f"arr_{i}"].reshape(n_ranks, -1)
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(got["valid"], valid.numpy())
    np.testing.assert_array_equal(got["overflow"], overflow.numpy())


def test_import_starts_no_process_group():
    code = (
        "import sys, torch\n"
        "before = {m for m in sys.modules if m.startswith('torch.distributed')}\n"
        "import radx_tpu_torch.parallel, radx_tpu_torch.parallel.multihost\n"
        "import radx_tpu_torch.parallel._worker\n"
        "import torch.distributed as dist\n"
        "after = {m for m in sys.modules if m.startswith('torch.distributed')}\n"
        "assert after == before, sorted(after - before)\n"
        "assert not dist.is_initialized(), 'a process group was started'\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def test_shard_global_takes_this_ranks_rows():
    mesh = SimpleNamespace(rank=2, size=4, device=torch.device("cpu"))
    x = np.arange(16, dtype=np.uint32)
    np.testing.assert_array_equal(multihost.shard_global(x, mesh).numpy(),
                                  x[8:12])
    with pytest.raises(ValueError):
        multihost.shard_global(x[:15], mesh)


def test_init_multihost_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        multihost.init_multihost("127.0.0.1:1", 1, 0)


def test_global_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError):
        multihost.global_mesh()
