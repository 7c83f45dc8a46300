"""Hand-written CUDA kernels for Hopper, and their plain PyTorch versions.

The counterpart of ``spark_rapids_tpu/kernels/pallas_tier.py``.  Each kernel
is CUDA C++ under ``csrc/``, compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use (into ``build/kernels``
at the repository root) and called through ``ctypes``.

Contract of every wrapper here:

* a CPU tensor takes the plain PyTorch version, beside the kernel in this
  module; a CUDA tensor launches the kernel, and anything the kernel does not
  take raises.  There is no fallback from the kernel to the plain version:
  the plain version exists for the CPU and to check the kernel against;
* the kernel launches on ``torch.cuda.current_stream()``, allocates nothing
  itself (the wrapper allocates with ``torch.empty``) and its C entry point
  returns ``cudaGetLastError()``, which the wrapper turns into an exception;
* each launch adds one to :func:`launch_count` for the kernel's name, so a
  run can show that its path went through the kernel.

Kernels: ``gatherScatter`` (:func:`pack_segments`), the k-way segment pack
behind ``layout.concat_kway``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> CUDA source under ``csrc/``
SOURCES = {"gatherScatter": "pack_segments.cu"}

#: inputs one gatherScatter launch takes (the kernel's by-value pointer
#: table, ``kMaxInputs`` in pack_segments.cu); more are packed in groups
PACK_MAX_INPUTS = 64

_launches: Dict[str, int] = {name: 0 for name in SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def launch_count(name: str) -> int:
    """Kernel launches of ``name`` since the last reset."""
    return _launches[name]


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default home
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib_{Path(SOURCES[name]).stem}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = CSRC_DIR / SOURCES[name]
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names: Sequence[str] = None) -> Dict[str, float]:
    """Compile every stale kernel library, one ``nvcc`` per source, all
    started together.  Returns seconds per library built; raises with the
    compiler's output if any build fails."""
    names = list(names or SOURCES)
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in names:
            if not _stale(name):
                continue
            tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, time.monotonic())
        took = {}
        failures = []
        for name, (proc, tmp, t0) in procs.items():
            out, _ = proc.communicate()
            took[name] = time.monotonic() - t0
            if proc.returncode != 0:
                failures.append(f"{SOURCES[name]}:\n{out}")
                continue
            os.replace(tmp, _lib_path(name))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return took


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    if name == "gatherScatter":
        ptr_array = ctypes.POINTER(ctypes.c_void_p)
        lib.srt_pack_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ptr_array,
            ctypes.POINTER(ctypes.c_longlong), ptr_array, ptr_array,
            ctypes.c_int, ctypes.c_void_p]
        lib.srt_pack_segments.restype = ctypes.c_int
        lib.srt_max_inputs.restype = ctypes.c_int
        if lib.srt_max_inputs() != PACK_MAX_INPUTS:
            raise RuntimeError("pack_segments.cu and cuda_tier disagree on "
                               "the inputs one launch takes")
    _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# gatherScatter: k-way segment pack
# ---------------------------------------------------------------------------


def _index_vector(vals, device) -> torch.Tensor:
    """int32[k] on ``device`` from 0-d tensors or ints, with no host sync
    (ints become device fills, not host-to-device copies)."""
    if isinstance(vals, torch.Tensor):
        return vals.reshape(-1).to(torch.int32)
    return torch.stack([
        v.reshape(()).to(torch.int32) if isinstance(v, torch.Tensor)
        else torch.full((), int(v), dtype=torch.int32, device=device)
        for v in vals])


def _bound_pointers(vals, sizes, device, is_lo: bool, keep: list):
    """Per-input device address of an int32 window bound, for the kernel
    to read itself; None where the bound is the default (lo 0, hi the
    input's size).  Converted or materialized bounds go into ``keep``."""
    if isinstance(vals, torch.Tensor):
        vals = vals.reshape(-1).to(torch.int32).unbind()
    out = []
    for v, n in zip(vals, sizes):
        if not isinstance(v, torch.Tensor):
            if int(v) == (0 if is_lo else n):
                out.append(None)
                continue
            v = torch.full((), int(v), dtype=torch.int32, device=device)
        elif v.device != device or v.numel() != 1:
            raise ValueError(f"window bound {tuple(v.shape)} on {v.device} "
                             f"is not a scalar on {device}")
        elif v.dtype != torch.int32:
            v = v.to(torch.int32)
        keep.append(v)
        out.append(v.data_ptr())
    return out


def pack_segments_reference(arrays: Sequence[torch.Tensor], los, his,
                            out_cap: int) -> torch.Tensor:
    """Plain PyTorch k-way segment pack: the port of the JAX package's
    ``layout._pack_kway`` scatter chain.  Input j's window
    ``[los[j], his[j])`` lands at the running offset of the earlier
    windows; zeros elsewhere.  Each input is one masked index write: row i
    outside the window (or past ``out_cap``) is aimed at its own scratch
    slot ``out_cap + i`` past the end, which is cut off."""
    device = arrays[0].device
    los = _index_vector(los, device).to(torch.int64)
    his = _index_vector(his, device).to(torch.int64)
    scratch = max(int(a.shape[0]) for a in arrays)
    out = torch.zeros(out_cap + scratch, dtype=arrays[0].dtype,
                      device=device)
    off = torch.zeros((), dtype=torch.int64, device=device)
    for j, vals in enumerate(arrays):
        iota = torch.arange(vals.shape[0], dtype=torch.int64, device=device)
        rel = iota - los[j]
        tgt = off + rel
        keep = (rel >= 0) & (iota < his[j]) & (tgt < out_cap)
        out.index_copy_(0, torch.where(keep, tgt, out_cap + iota), vals)
        off = off + (his[j] - los[j])
    return out[:out_cap]


def pack_segments(arrays: Sequence[torch.Tensor], los, his,
                  out_cap: int) -> torch.Tensor:
    """K-way segment pack: ``out[dst_j + t] = arrays[j][los[j] + t]`` for
    ``t < his[j] - los[j]``, ``dst_j`` the running total of earlier window
    lengths, zeros past the total.

    ``arrays`` are 1-D tensors of one dtype on one device; ``los``/``his``
    are 0-d integer tensors on that device (a batch's ``num_rows``) or
    ints, with ``0 <= lo <= hi <= len``.  CPU tensors take
    :func:`pack_segments_reference`; CUDA tensors launch the kernel, which
    reads the bounds from device memory itself: one launch, no host
    sync."""
    if not arrays:
        raise ValueError("pack_segments needs at least one input")
    a0 = arrays[0]
    device, dtype = a0.device, a0.dtype
    for a in arrays:
        if a.dim() != 1 or a.dtype != dtype or a.device != device:
            raise ValueError(
                "pack_segments inputs must be 1-D tensors of one dtype on "
                f"one device; got {a.dtype} {tuple(a.shape)} on {a.device}, "
                f"expected {dtype} on {device}")
    if len(los) != len(arrays) or len(his) != len(arrays):
        raise ValueError("pack_segments needs one lo and one hi per input")
    if out_cap < 0 or out_cap >= 2 ** 31:
        raise ValueError(f"out_cap {out_cap} outside [0, 2^31)")
    if device.type == "cpu":
        return pack_segments_reference(arrays, los, his, out_cap)
    if device.type != "cuda":
        raise ValueError(f"pack_segments has no kernel for {device}")
    width = a0.element_size()
    if width not in (1, 2, 4, 8) or dtype.is_complex:
        raise ValueError(f"pack_segments has no kernel for {dtype}")
    for a in arrays:
        if not a.is_contiguous():
            raise ValueError("pack_segments inputs must be contiguous")
    k = len(arrays)
    if k > PACK_MAX_INPUTS:
        # pack groups into intermediates, then pack the intermediates
        los_t = _index_vector(los, device)
        his_t = _index_vector(his, device)
        parts, totals = [], []
        for g in range(0, k, PACK_MAX_INPUTS):
            sl = slice(g, g + PACK_MAX_INPUTS)
            cap_g = sum(int(a.shape[0]) for a in arrays[sl])
            parts.append(pack_segments(arrays[sl], los_t[sl], his_t[sl],
                                       cap_g))
            totals.append((his_t[sl] - los_t[sl]).sum().to(torch.int32))
        return pack_segments(parts, [0] * len(parts), totals, out_cap)
    out = torch.empty(out_cap, dtype=dtype, device=device)
    if out_cap == 0:
        return out
    sizes = [int(a.shape[0]) for a in arrays]
    keep: list = []
    lo_ptrs = _bound_pointers(los, sizes, device, True, keep)
    hi_ptrs = _bound_pointers(his, sizes, device, False, keep)
    void_k = ctypes.c_void_p * k
    lib = _lib("gatherScatter")
    with torch.cuda.device(device):
        err = lib.srt_pack_segments(
            out.data_ptr(), out_cap, width,
            void_k(*[a.data_ptr() for a in arrays]),
            (ctypes.c_longlong * k)(*sizes), void_k(*lo_ptrs),
            void_k(*hi_ptrs), k, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gatherScatter launch failed: CUDA error {err}")
    _launches["gatherScatter"] += 1
    return out
