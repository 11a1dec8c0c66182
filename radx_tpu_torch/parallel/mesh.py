"""Device meshes of the distributed sort — port of radx_tpu/parallel/mesh.py.

A ``Mesh`` is the counterpart of a one-axis ``jax.sharding.Mesh``: a list of
``torch.device``s and an axis name.  ``parallel/dist_sort.py`` runs its D
shard bodies in this one process, phase by phase; an exchange wave is a copy
of each run to its destination shard's device.

A mesh may list one device several times.  Its shards then share that
device, as the JAX tests' virtual CPU devices share the host
(``xla_force_host_platform_device_count``): that is how the CPU tests run
the exchange at D = 2..8, and how one card runs it at D = 8.  Such a run
shows that the exchange is right, not how it scales.

``parallel/multihost.py`` has the other kind, one shard per process of a
``torch.distributed`` group.
"""

from __future__ import annotations

import torch


class Mesh:
    """One-axis mesh of the shards that one process runs.

    ``devices[d]`` holds shard d; a device may appear more than once."""

    def __init__(self, devices, axis: str = "d"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def transport(self):
        return InProcess(self.devices)


class InProcess:
    """The exchange of a ``Mesh``: every shard lives in this process.

    The collectives take one tensor per shard (in shard order) and return
    one result per shard, on that shard's device.  No result is written in
    place by its receiver's sort: a run that stays on its device is passed
    by reference."""

    whole = True  # the caller passes the global array, split here

    def __init__(self, devices):
        self.devices = devices
        self.size = len(devices)
        self.local = list(range(self.size))

    def device(self, i: int) -> torch.device:
        return self.devices[i]

    def all_gather(self, parts):
        """Each shard gets the concatenation of every shard's part."""
        whole = torch.cat([p.to(self.devices[0]) for p in parts])
        return [whole.to(d) for d in self.devices]

    def max(self, parts):
        """Each shard gets the elementwise max over the shards' parts."""
        top = torch.stack([p.to(self.devices[0]) for p in parts]).amax(0)
        return [top.to(d) for d in self.devices]

    def wave(self, sends):
        """One exchange wave: ``sends[k] = (dst, src, planes, recv_rows)``
        for shard k, a permutation of the shards: shard k sends its run's
        planes to ``dst`` and receives ``recv_rows`` rows a plane from
        ``src``.  Returns, per shard, the planes that its source sent (on
        its device: a run that stays on its device is passed by
        reference)."""
        got = {}
        for dst, _src, planes, _rows in sends:
            dev = self.devices[dst]
            got[dst] = [p.to(dev) for p in planes]
        for i, (_dst, _src, _planes, rows) in zip(self.local, sends):
            if any(p.numel() != rows for p in got[i]):
                raise RuntimeError(f"shard {i} expected runs of {rows} rows")
        return [got[i] for i in self.local]


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    """Mesh over the first ``n_devices`` CUDA devices (default: all of
    them).  Raises ValueError when the machine has fewer."""
    have = torch.cuda.device_count()
    want = have if n_devices is None else n_devices
    if want > have or want < 1:
        raise ValueError(f"requested {want} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(want)], axis)
