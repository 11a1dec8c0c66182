"""Pinned staging of the streaming operators' host <-> device copies.

Every byte that ``ops/chunked`` moves between a numpy array and the card
goes through ``Staging``: two rings (one a direction) of ``RING`` pinned
host pieces of ``PIECE_BYTES`` bytes each, each ring with a copy stream and
``THREADS`` host copy threads of its own.

  * Up (``put`` / ``upload``, on the caller's thread): the array is cut into
    pieces of at most ``PIECE_BYTES`` bytes (``spans``).  For piece k the
    host waits for the event of ring slot k mod ``RING`` (that slot's last
    copy to the card), copies the rows into the slot, issues the slot's
    copy to the card on the up stream and records the slot's event.  The
    host copy of piece k + 1 runs under the card's copy of piece k.
  * Down (``get`` / ``fetch``, on a download thread): ``get`` records an
    event on the compute stream and queues the copy; the down stream waits
    for that event, then copies up to ``RING`` pieces into its ring ahead of
    the host, which copies each slot into the numpy output once its event
    has completed.  So a slab's results come down while the caller uploads
    the next slab.  ``wait`` returns when every queued output is written.

A device tensor that the up stream fills is allocated on it (``empty``)
and handed to the compute stream (``handoff``: ``wait_stream`` and
``record_stream``); one that the down stream reads is recorded on it
(``get``), and the queued copy holds it.  So the caching allocator reuses
neither while the other stream may still touch it.

A CUDA call never takes pageable memory: the rings are allocated with
``pin_memory=True`` and a piece that is not pinned raises.  On a CPU
device, which the caller has to ask for, the same schedule runs over
ordinary host pieces with no stream and no event.  The rings are allocated
per ``Staging`` object; PyTorch's caching host allocator keeps freed pinned
blocks, so only a process's first rings pay for pinning.

``STATS`` counts what went through the rings (pieces, bytes, the host
seconds of the copies) and how many pieces moved through pinned memory on
a copy stream; ``reset_stats`` sets it to 0.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from concurrent import futures
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PIECE_BYTES = 32 << 20
RING = 4
THREADS = 4  # host copy threads a piece

STATS = dict.fromkeys(("pieces_up", "pieces_down", "bytes_up", "bytes_down",
                       "seconds_up", "seconds_down", "pinned_pieces"), 0)
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = 0


def _count(way: str, pieces: int, nbytes: int, seconds: float, pinned: bool):
    with _STATS_LOCK:
        STATS["pieces_" + way] += pieces
        STATS["bytes_" + way] += nbytes
        STATS["seconds_" + way] += seconds
        STATS["pinned_pieces"] += pieces if pinned else 0


def spans(n: int, itemsize: int, piece_bytes: int) -> list[tuple[int, int]]:
    """The piece schedule of ``n`` rows of ``itemsize`` bytes: (lo, hi) row
    ranges of at most ``piece_bytes`` bytes each, covering [0, n) in
    order."""
    if itemsize > piece_bytes:
        raise ValueError(f"a row of {itemsize} bytes exceeds the "
                         f"{piece_bytes}-byte piece")
    step = piece_bytes // itemsize
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Ring:
    """``RING`` host pieces, one event each, a copy stream and a pool of
    host copy threads; used by one thread at a time."""

    def __init__(self, device: torch.device, cuda: bool):
        self.cuda = cuda
        self.piece_bytes = PIECE_BYTES
        buf = torch.empty(RING * self.piece_bytes, dtype=torch.uint8,
                          pin_memory=cuda)
        if cuda and not buf.is_pinned():
            raise RuntimeError("the staging ring is not pinned")
        self.pieces = [buf[i * self.piece_bytes: (i + 1) * self.piece_bytes]
                       for i in range(RING)]
        self.host = [p.numpy() for p in self.pieces]
        self._next = 0
        self.pool = ThreadPoolExecutor(THREADS)
        if cuda:
            self.stream = torch.cuda.Stream(device)
            self.events = [torch.cuda.Event() for _ in range(RING)]
            self._used = [False] * RING

    def on_stream(self):
        return (torch.cuda.stream(self.stream) if self.cuda
                else contextlib.nullcontext())

    def take(self) -> int:
        """The next slot, once its last copy to or from the card is done."""
        k = self._next
        self._next = (k + 1) % len(self.pieces)
        if self.cuda:
            if self._used[k]:
                self.events[k].synchronize()
            if not self.pieces[k].is_pinned():
                raise RuntimeError("a staging piece is not pinned")
        return k

    def issued(self, k: int) -> None:
        """Slot ``k``'s copy to or from the card is on the stream."""
        if self.cuda:
            self.events[k].record(self.stream)
            self._used[k] = True

    def done(self, k: int) -> None:
        """Wait for slot ``k``'s last copy."""
        if self.cuda:
            self.events[k].synchronize()

    def host_copy(self, dst: np.ndarray, src: np.ndarray) -> None:
        """``dst[:] = src`` (bytes), in ``THREADS`` ranges on the pool
        (``np.copyto`` releases the GIL)."""
        step = -(-dst.shape[0] // THREADS)
        list(self.pool.map(
            lambda lo: np.copyto(dst[lo: lo + step], src[lo: lo + step]),
            range(0, dst.shape[0], step)))


class Staging:
    """The rings, the compute stream (the current stream when it is made)
    and the download thread of one streamed call on ``device``; a context
    manager, which waits for the queued downloads and stops the threads."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.up = _Ring(self.device, self.cuda)
        self.down = _Ring(self.device, self.cuda)
        self.compute = (torch.cuda.current_stream(self.device) if self.cuda
                        else None)
        self._worker = ThreadPoolExecutor(1)
        self._queued = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                self.wait()
            else:  # the caller's error wins; the copies still end first
                futures.wait(self._queued)
        finally:
            for pool in (self._worker, self.up.pool, self.down.pool):
                pool.shutdown()

    def empty(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        """``n`` rows on the device, allocated on the up stream (for
        ``put``, then ``handoff``)."""
        with self.up.on_stream():
            return torch.empty(n, dtype=dtype, device=self.device)

    def put(self, arr: np.ndarray, dst: torch.Tensor) -> None:
        """Copy the rows of the contiguous 1-D ``arr`` into ``dst`` (from
        ``empty``, or a slice of it) through the up ring.  Returns once
        every piece is issued; ``handoff`` orders the compute stream after
        it."""
        if dst.shape != arr.shape or dst.element_size() != arr.itemsize:
            raise ValueError(f"cannot stage {arr.shape} {arr.dtype} rows "
                             f"into {tuple(dst.shape)} {dst.dtype}")
        t0 = time.perf_counter()
        ring, s = self.up, arr.itemsize
        src, out = arr.view(np.uint8), dst.view(torch.uint8)
        pieces = spans(arr.shape[0], s, ring.piece_bytes)
        for lo, hi in pieces:
            k = ring.take()
            lo, hi = lo * s, hi * s
            ring.host_copy(ring.host[k][: hi - lo], src[lo:hi])
            with ring.on_stream():
                out[lo:hi].copy_(ring.pieces[k][: hi - lo],
                                 non_blocking=self.cuda)
            ring.issued(k)
        _count("up", len(pieces), arr.nbytes, time.perf_counter() - t0,
               self.cuda)

    def handoff(self, t: torch.Tensor) -> torch.Tensor:
        """Order the compute stream after the copies issued so far, and
        keep ``t``'s memory from reuse until the compute stream is done."""
        if self.cuda:
            self.compute.wait_stream(self.up.stream)
            t.record_stream(self.compute)
        return t

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """A contiguous 1-D numpy array as a new tensor on the device,
        ready for the compute stream."""
        dst = self.empty(arr.shape[0], torch_dtype(arr.dtype))
        self.put(arr, dst)
        return self.handoff(dst)

    def get(self, src: torch.Tensor, out: np.ndarray) -> None:
        """Queue a copy of the 1-D device tensor ``src``, as the compute
        stream's work so far leaves it, into the contiguous numpy array
        ``out``; ``out`` is written once ``wait`` returns."""
        if out.shape != tuple(src.shape) or out.itemsize != src.element_size():
            raise ValueError(f"cannot stage {tuple(src.shape)} {src.dtype} "
                             f"rows into {out.shape} {out.dtype}")
        src = src.contiguous()
        ready = None
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record(self.compute)
            src.record_stream(self.down.stream)
        self._queued.append(self._worker.submit(self._get, src, out, ready))

    def _get(self, src: torch.Tensor, out: np.ndarray, ready) -> None:
        """The download thread's copy of ``src`` into ``out``: up to
        ``RING`` pieces on the down stream ahead of the host copies."""
        t0 = time.perf_counter()
        ring, s = self.down, out.itemsize
        dst, sbytes = out.view(np.uint8), src.view(torch.uint8)
        pieces = spans(out.shape[0], s, ring.piece_bytes)
        pending = collections.deque()

        def drain():
            k, lo, hi = pending.popleft()
            ring.done(k)
            ring.host_copy(dst[lo:hi], ring.host[k][: hi - lo])

        with ring.on_stream():
            if self.cuda:
                ring.stream.wait_event(ready)
            for lo, hi in pieces:
                if len(pending) == len(ring.pieces):
                    drain()  # the slot that take() returns next
                k = ring.take()
                lo, hi = lo * s, hi * s
                ring.pieces[k][: hi - lo].copy_(sbytes[lo:hi],
                                                non_blocking=self.cuda)
                ring.issued(k)
                pending.append((k, lo, hi))
        while pending:
            drain()
        _count("down", len(pieces), out.nbytes, time.perf_counter() - t0,
               self.cuda)

    def wait(self) -> None:
        """Block until every queued ``get`` has written its output; raise
        the first copy's error."""
        queued, self._queued = self._queued, []
        futures.wait(queued)
        for f in queued:
            f.result()

    def fetch(self, src: torch.Tensor) -> np.ndarray:
        """A new numpy array that a queued copy of the 1-D device tensor
        ``src`` fills (written once ``wait`` returns)."""
        out = np.empty(tuple(src.shape), numpy_dtype(src.dtype))
        self.get(src, out)
        return out
