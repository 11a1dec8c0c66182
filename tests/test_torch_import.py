"""The port imports neither JAX, Triton, the JAX package (radx_tpu) nor its
tools (tools/), and touches no CUDA state when imported (it must load on
machines without a card, and a test worker that imports it must not
initialise CUDA)."""

import subprocess
import sys

import pytest

MODULES = (
    "radx_tpu_torch",
    "radx_tpu_torch.config",
    "radx_tpu_torch.kernels.bitonic",
    "radx_tpu_torch.kernels.compact",
    "radx_tpu_torch.kernels.segscan",
    "radx_tpu_torch.kernels.aggregate",
    "radx_tpu_torch.kernels.gather",
    "radx_tpu_torch.kernels._build",
    "radx_tpu_torch.ops.sort",
    "radx_tpu_torch.ops.filter",
    "radx_tpu_torch.ops.groupby",
    "radx_tpu_torch.ops.distinct",
    "radx_tpu_torch.ops.topk",
    "radx_tpu_torch.ops.join",
    "radx_tpu_torch.ops.table",
    "radx_tpu_torch.ops.lazy",
    "radx_tpu_torch.ops.chunked",
    "radx_tpu_torch.parallel",
    "radx_tpu_torch.parallel.mesh",
    "radx_tpu_torch.parallel.dist_sort",
    "radx_tpu_torch.parallel.multihost",
    "radx_tpu_torch.parallel.dryrun",
    "radx_tpu_torch.parallel._worker",
    "radx_tpu_torch.utils.guard",
    "radx_tpu_torch.examples.query_pipeline",
    "radx_tpu_torch.utils.timing",
    "radx_tpu_torch.bench",
    "radx_tpu_torch.bench_suite",
    "radx_tpu_torch.tools.autotune",
    "radx_tpu_torch.tools.bench_strategies",
    "radx_tpu_torch.tools.dryrun_scale",
    "radx_tpu_torch.tools.scaling_model",
    "radx_tpu_torch.utils",
    "radx_tpu_torch.utils.debug",
    "radx_tpu_torch.oracle",
    "radx_tpu_torch.oracle.cpu",
    "radx_tpu_torch.oracle.native",
    "radx_tpu_torch.runtime",
    "radx_tpu_torch.runtime.native",
)


@pytest.mark.parametrize("module", MODULES)
def test_import_is_backend_free(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "import torch\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'radx_tpu') if m in sys.modules]\n"
        "bad += [m for m in sys.modules if m.startswith('radx_tpu.')]\n"
        "bad += [m for m in sys.modules if m == 'tools' or m.startswith('tools.')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised at import'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
