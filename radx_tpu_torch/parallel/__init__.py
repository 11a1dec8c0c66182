"""Multi-device layer of the port — radx_tpu/parallel on ``torch.distributed``.

  * mesh.py — ``Mesh`` (the shards that one process runs; a device may be
    listed several times) and ``make_mesh``;
  * dist_sort.py — the distributed sample-splitter sort (flat and
    hierarchical exchange), written once against a transport;
  * multihost.py — one shard per rank of a process group: ``init_multihost``,
    ``global_mesh``, ``shard_global``, ``allgather_result``,
    ``sort_sharded_guarded``;
  * dryrun.py — ``dryrun_multichip``: flat, hier and stable pairs on one
    mesh, checked against numpy;
  * _worker.py — one rank of a multi-process run (``python -m``).

Importing the package starts no CUDA and no process group.
"""

from radx_tpu_torch.parallel import dist_sort  # noqa: F401
from radx_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
from radx_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
