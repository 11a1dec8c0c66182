"""Build and load the port's CUDA kernels (no counterpart in radx_tpu).

The sources in ``radx_tpu_torch/csrc/`` expose a plain C interface, so they
are compiled by ``nvcc`` alone and bound with ``ctypes`` — no PyTorch
headers, which keeps a build to seconds.  Each source compiles to an object
in its own ``nvcc`` process, all started together, and one more ``nvcc``
links the objects into one shared library.  The library is built at first
use into ``radx_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as is.  A missing ``nvcc`` or a failed build raises with the
compiler's output; nothing falls back to another implementation.
``build_host`` / ``load_host`` do the same with g++ for the host C++ of
``csrc/host/`` (the oracle and the runtime's generators).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
)

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    # planes, np, ncmp, n, log_c, invert, ascending, plan, phases, top,
    # stream
    "radx_chunk_sort": (_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P),
    # planes, np, ncmp, n, rows, j_low, f, kk, log_l, invert, log_span,
    # plan, phases, top, stream
    "radx_cross_stage": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                         _I, _I, _P),
    # planes, np, ncmp, n, log_t, invert, log_span, plan, phases, top,
    # stream
    "radx_finish": (_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P),
    # planes, np, ncmp, n, log_c, invert, sources, row0, key, key_rows,
    # key_xor, plan, phases, top, stream
    "radx_chunk_sort_src": (_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _P,
                            _I, _I, _P),
    # planes, np, ncmp, n, log_t, invert, log_span, key, key_rows, key_xor,
    # plan, phases, top, stream
    "radx_finish_out": (_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I,
                        _P),
    # in, out, np, ncmp, n, log_t, log_c, plan, phases, top, stream
    "radx_chunk_sort_cyclic": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P),
    # planes, np, ncmp, n, log_t, log_c, sources, row0, plan, phases, top,
    # stream
    "radx_chunk_sort_cyclic_src": (_P, _I, _I, _I, _I, _I, _P, _I, _P, _I,
                                   _I, _P),
    # in, out, np, ncmp, n, log_t, log_s, log_c, plan, phases, top, stream
    "radx_slot_merge": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P),
    # keys, n, rows, log_tile, shift, bias, out, totals, stream
    "radx_radix_hist": (_P, _I, _I, _I, _I, _I, _P, _P, _P),
    # keys, n_chunks, log_c, heads, log_r, first, samples, n_samples,
    # totals, pads, n_valid, log_tile, log_slot, nb, nb_pad, tail,
    # splitters, bounds, start, src, overflow, scratch, stream
    "radx_radix_rank": (_P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I,
                        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # in, out, np, ncmp, n_chunks, log_c, bounds, nb_pad, log_slot, stream
    "radx_radix_pack": (_P, _P, _I, _I, _I, _I, _P, _I, _I, _P),
    # merged, sorted, out, np, ncmp, start, src, n_seg, n_merged, total,
    # stream
    "radx_radix_concat": (_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P),
    # merged, sorted, out, np, ncmp, start, src, n_seg, n_merged, total,
    # key, key_rows, key_xor, stream
    "radx_radix_concat_out": (_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                              _I, _I, _P),
    # keys, values, n, bins, n_valid (or null), sums, counts, stream
    "radx_dense_sums": (_P, _P, _I, _I, _P, _P, _P, _P),
    # keys, ovals, n, bins, is_min, n_valid (or null), ext, counts, stream
    "radx_dense_extrema": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    # mask, mask bytes, n, n_valid (or null), ins, outs, planes, scratch,
    # count, stream
    "radx_compact": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P),
    # keys, n, log_tile, vals, flags, outs, out_flags, scratch, op, dtype, m,
    # stream
    "radx_segscan": (_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # index, n, sources, source rows, outs, num_src, mode, stream
    "radx_gather_planes": (_P, _I, _P, _P, _P, _I, _I, _P),
    # index, n, rows0, rows1, tagged, log_w, log_tile, counts, stream
    "radx_gather_count": (_P, _I, _I, _I, _I, _I, _I, _P, _P),
    # counts, buckets, tiles, offsets, totals, stream
    "radx_gather_scan": (_P, _I, _I, _P, _P, _P),
    # index, n, rows0, rows1, tagged, log_w, log_tile, offsets, totals, P,
    # stream
    "radx_gather_part": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # index, n, rows0, rows1, tagged, log_w, log_tile, offsets, totals, V,
    # out0, out1, stream
    "radx_gather_place": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P),
    # a, na, b, nb, out, np, ncmp, key_xor, stream
    "radx_merge_runs": (_P, _I, _P, _I, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class BuildError(RuntimeError):
    """nvcc is missing or rejected the sources."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise BuildError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
        "radx_tpu_torch cannot be built"
    )


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _hash(parts) -> str:
    """16 hex digits of a hash of byte strings (tools, flags, sources)."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part + b"\0")
    return h.hexdigest()[:16]


def _digest(nvcc: str) -> str:
    # the compiler, its flags, the sources and their headers
    return _hash([*(f.encode() for f in (nvcc, *NVCC_FLAGS)),
                  *(src.name.encode() + b"\0" + src.read_bytes()
                    for src in sorted(CSRC.glob("*.cu*")))])


def library_path() -> tuple[pathlib.Path, pathlib.Path]:
    """(shared library, compiler log) paths for the current sources."""
    stem = BUILD_DIR / f"libradx_kernels_{_digest(_nvcc())}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source, all at once, then one link."""
    nvcc = _nvcc()
    so, log = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for obj, src in zip(objs, sources())]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        done = list(zip(cmds, pool.map(_run, cmds)))
    if all(proc.returncode == 0 for _, proc in done):
        done.append((link, _run(link)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    log.write_text("\n".join(" ".join(cmd) + "\n" + proc.stdout + proc.stderr
                             for cmd, proc in done))
    return _publish(done, tmp, so, "nvcc")


def _publish(done, tmp: pathlib.Path, so: pathlib.Path, tool: str
             ) -> pathlib.Path:
    """Raise with the compiler's output if a step of ``done`` ((command,
    process) pairs) failed, else move the library built at ``tmp`` (a name
    of this process) to ``so`` in one rename, so that a concurrent build
    never loads half a file."""
    for _, proc in done:
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(
                f"{tool} failed ({proc.returncode}):\n{proc.stdout}"
                f"{proc.stderr}")
    os.replace(tmp, so)
    return so


# host C++ (csrc/host/): no -march=native, so that a library built on one
# host runs on another that loads the same checkout
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build_host(source: pathlib.Path) -> pathlib.Path:
    """Compile one host C++ source (``csrc/host/``) with g++ into a shared
    library in ``BUILD_DIR`` named by a hash of the source, compiler and
    flags, unless it exists.  A missing g++ or a failed build raises."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise BuildError(f"g++ not found: {source.name} cannot be built")
    digest = _hash([*(f.encode() for f in (gxx, *HOST_FLAGS)),
                    source.read_bytes()])
    so = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *HOST_FLAGS, str(source), "-o", str(tmp)]
    return _publish([(cmd, _run(cmd))], tmp, so, "g++")


_host_libs: dict[pathlib.Path, ctypes.CDLL] = {}


def load_host(source: pathlib.Path, signatures: dict) -> ctypes.CDLL:
    """The library of one host source, built on first use and bound once
    per process; ``signatures`` maps each C function to its (argtypes,
    restype)."""
    with _lock:
        lib = _host_libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(source)))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _host_libs[source] = lib
        return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.radx_error_string.argtypes = (ctypes.c_int,)
            lib.radx_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if code != 0:
        msg = lib.radx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(counts: dict, name: str, fn_name: str, device: torch.device,
           *args) -> None:
    """The one launch path of every kernel wrapper: call the C entry point
    ``fn_name(*args, stream)`` on the current stream of ``device``, raise
    if it returns a CUDA error, and add one to ``counts[name]``.

    The library is bound once (the lock is taken only until then).  A
    kernel launches on the calling thread's current device, so the device
    is switched only when the tensors lie on another one."""
    lib = _lib if _lib is not None else load()
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    with (contextlib.nullcontext() if index == current
          else torch.cuda.device(index)):
        code = getattr(lib, fn_name)(
            *args, torch._C._cuda_getCurrentRawStream(index))
    check(lib, code, name)
    counts[name] += 1
