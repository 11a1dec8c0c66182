"""One shard per process — port of radx_tpu/parallel/multihost.py on
``torch.distributed``.

``init_multihost`` joins this process to a process group (NCCL on a card,
gloo on the CPU, ``tcp://`` rendezvous); ``global_mesh`` is the group as a
mesh, one shard per rank.  ``parallel/dist_sort.py`` runs the same shard
body over it as over an in-process ``Mesh``, through ``Group``, the
process-group transport:

  * the samples through ``dist.all_gather``;
  * each exchange wave as one ``dist.batch_isend_irecv`` of the run's
    planes at their own length: every rank posts its send to the wave's
    destination and its receive from the wave's source, both sized from the
    run lengths that every rank read (``dist_sort._run_table``), so the op
    lists of a wave match on every rank (the hierarchical exchange's
    subgroups are sets of peers in the default group);
  * the overflow through ``all_reduce(MAX)``.

On a group mesh the sort takes this rank's shard (``shard_global``) and
returns this rank's row, valid count and the global overflow flag;
``allgather_result`` assembles the rows of every rank on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from radx_tpu_torch.parallel.mesh import Mesh


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_ids: list[int] | None = None,
                   *, device=None):
    """Join the job's process group; call once per process.

    ``coordinator_address`` is ``host:port`` of rank 0 (or a ``tcp://``
    URL).  On ``device="cuda"`` (the default) the group runs NCCL on the
    card ``local_device_ids[0]``, or else ``process_id % device_count``;
    on ``device="cpu"`` it runs gloo."""
    import torch.distributed as dist

    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: no CUDA device (pass "
                               "device='cpu' for a gloo group)")
        index = (local_device_ids[0] if local_device_ids
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {kind!r} devices")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


class GroupMesh:
    """The process group as a one-axis mesh: shard r on rank r's device."""

    def __init__(self, axis: str = "d"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("call init_multihost first")
        self.axis = axis
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl" else torch.device("cpu"))

    def transport(self):
        return Group(self.rank, self.size, self.device)


class Group:
    """The process-group transport of the distributed sort: this rank's
    shard only.  Each operation takes and returns a one-element list."""

    whole = False  # the caller passes this rank's shard

    def __init__(self, rank: int, size: int, device: torch.device):
        self.size = size
        self.local = [rank]
        self._device = device

    def device(self, i: int) -> torch.device:
        return self._device

    def all_gather(self, parts):
        import torch.distributed as dist

        (p,) = parts
        bufs = [torch.empty_like(p) for _ in range(self.size)]
        dist.all_gather(bufs, p.contiguous())
        return [torch.cat(bufs)]

    def max(self, parts):
        import torch.distributed as dist

        (p,) = parts
        top = p.reshape(1).clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        return [top.reshape(())]

    def wave(self, sends):
        """One wave: this rank's run (``planes``) to ``dst`` and
        ``recv_rows`` rows a plane from ``src``, one ``isend`` / ``irecv``
        a plane in one ``batch_isend_irecv`` (none for an empty run: both
        sides know its length)."""
        import torch.distributed as dist

        ((dst, src, planes, recv_rows),) = sends
        got = [torch.empty(recv_rows, dtype=p.dtype, device=self._device)
               for p in planes]
        ops = []
        for tag, (p, r) in enumerate(zip(planes, got)):
            if p.numel():
                ops.append(dist.P2POp(dist.isend, p.contiguous(), dst,
                                      tag=tag))
            if recv_rows:
                ops.append(dist.P2POp(dist.irecv, r, src, tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [got]


def global_mesh(axis: str = "d") -> GroupMesh:
    """One-axis mesh over every rank of the process group."""
    return GroupMesh(axis)


def shard_global(host_array, mesh: GroupMesh) -> torch.Tensor:
    """This rank's shard of an array that every rank holds whole (made from
    a shared seed, or read from shared storage), on the rank's device.
    The length must divide by the group size, as a sharded JAX array's
    must."""
    n = host_array.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} "
                         "ranks")
    m = n // mesh.size
    part = np.ascontiguousarray(host_array[mesh.rank * m: (mesh.rank + 1) * m])
    return torch.from_numpy(part).to(mesh.device)


def allgather_result(x: torch.Tensor) -> np.ndarray:
    """Every rank's block of a result, concatenated along dim 0, as numpy
    on every rank (small results only)."""
    import torch.distributed as dist

    wire = x.to(torch.int32) if x.dtype == torch.bool else x
    if wire.element_size() == 4:
        wire = wire.view(torch.int32)
    bufs = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, wire.contiguous())
    out = torch.cat(bufs)
    out = out.to(torch.bool) if x.dtype == torch.bool else out.view(x.dtype)
    return out.cpu().numpy()


def _collective_timeout_s(n_keys: int, n_devices: int) -> float:
    """Deadline of one distributed sort step: a generous multiple of a slow
    single-device rate (0.1 G keys/s covers the plain versions on a CPU and
    a cold build) plus a fixed floor for bring-up."""
    per_device = max(n_keys // max(n_devices, 1), 1)
    return 60.0 + per_device / 0.1e9 * 20.0


def sort_sharded_guarded(keys, mesh, *, capacity: int | None = None, cfg=None,
                         timeout_s: float | None = None, retries: int = 2,
                         on_retry=None):
    """``dist_sort.sort_sharded`` under the failure guard: a deadline sized
    to the work, then up to ``retries`` relaunches after a timeout or a
    ``torch.distributed.DistError`` (``utils.guard.retry_deterministic``).
    The sort is a pure function of ``keys``, so a retry gives the same
    bits.  ``on_retry(attempt, exc)`` must rebuild the process group after
    a timeout of a hung collective."""
    from radx_tpu_torch.parallel import dist_sort
    from radx_tpu_torch.utils import guard

    if timeout_s is None:
        n = keys.shape[0] * (1 if isinstance(mesh, Mesh) else mesh.size)
        timeout_s = _collective_timeout_s(n, mesh.size)

    def step():
        if capacity is None:
            return dist_sort.sort_sharded(keys, mesh, axis=mesh.axis, cfg=cfg)
        return dist_sort.sort_sharded(keys, mesh, axis=mesh.axis,
                                      capacity=capacity, cfg=cfg)

    return guard.retry_deterministic(step, retries=retries,
                                     timeout_s=timeout_s, on_retry=on_retry)
