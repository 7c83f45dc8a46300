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
* each call that launches adds to :func:`launch_count` for the kernel's
  name, so a run can show that its path went through the kernel: one per
  launch for gatherScatter, stringHash and strings, one per call for
  joinProbe (whose call is two launches);
* a launch that returns a CUDA error raises :class:`KernelLaunchError` with
  the code, which the fault ladder classifies (an allocation failure is
  retried after a spill; any other code is raised to the caller, never
  replayed or completed on the host).

Kernels: ``gatherScatter``, the k-way segment pack (:func:`pack_columns`:
every buffer of ``layout.concat_kway`` in one launch; :func:`pack_segments`:
one buffer with any windows); ``stringHash`` (:func:`string_hash_columns`:
every string column of a sort in one launch; :func:`string_hash_rows`: one
column), the dual polynomial row hashes behind string grouping, equality
and sort tie-breaks; ``strings`` (:func:`rows_with_match`), the contains
scan behind ``LIKE '%needle%'``; ``joinProbe`` (:func:`probe_join`), the
candidate phase of the static equi-join (``join.join_pairs_static``).
"""

from __future__ import annotations

import array
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.fault.errors import KernelLaunchError

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> CUDA source under ``csrc/``
SOURCES = {"gatherScatter": "pack_segments.cu",
           "stringHash": "string_hash.cu",
           "strings": "contains.cu",
           "joinProbe": "probe_join.cu"}

#: bases of the two row hashes and the length mix (the JAX package's
#: ``exprs/strings.py`` ``_HASH_BASES`` and ``0x9E3779B9``)
HASH_BASES = (31, 131)
HASH_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF

_launches: Dict[str, int] = {name: 0 for name in SOURCES}
_libs: Dict[str, ctypes.CDLL] = {}
_needles: Dict[tuple, torch.Tensor] = {}  # (needle, device index) -> u8
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


def load(name: str) -> ctypes.CDLL:
    """The kernel library of ``name``, built first if it is stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    if name == "gatherScatter":
        lib.srt_pack_multi.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.srt_pack_multi.restype = ctypes.c_int
        lib.srt_pack_max_words.restype = ctypes.c_int
    elif name == "stringHash":
        lib.srt_string_hash_columns.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
            ctypes.c_uint, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.srt_string_hash_columns.restype = ctypes.c_int
    elif name == "strings":
        lib.srt_contains.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.srt_contains.restype = ctypes.c_int
    elif name == "joinProbe":
        lib.srt_probe_join_workspace.argtypes = [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.srt_probe_join_workspace.restype = ctypes.c_longlong
        lib.srt_probe_join.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] +
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] +
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] +
            [ctypes.c_void_p] * 2)
        lib.srt_probe_join.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def _launch(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, entering the
    device's context only when it is not the current device already.
    Returns the C entry point's error code.  The stream's handle comes
    from ``torch._C._cuda_getCurrentRawStream`` (what ``torch.cuda.
    current_stream(device).cuda_stream`` reads, without building a Stream
    object, which took 3-6.5 us a call beside an H100, ``ab_kernels.py``)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    return fn(*args, torch._C._cuda_getCurrentRawStream(index))


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


def pack_columns_reference(columns, num_rows, out_cap: int,
                           byte_caps: Sequence[int]) -> list:
    """Plain PyTorch concat of every buffer of k batches: the port of the
    JAX package's ``layout.concat_kway`` body.  Each buffer is one
    :func:`pack_segments_reference` over the row windows ``[0,
    num_rows[j])``; a string column's bytes are packed over ``[0,
    offsets_j[num_rows[j]])`` and its offsets rebuilt from one int32
    cumsum of the packed row lengths.  Arguments as :func:`pack_columns`."""
    return _pack_windows_reference(columns, [0] * len(num_rows), num_rows,
                                   out_cap, byte_caps)


def pack_column_windows_reference(columns, starts, counts, out_cap: int,
                                  byte_caps: Sequence[int]) -> list:
    """Plain PyTorch form of :func:`pack_column_windows`: the port of the
    JAX package's ``layout.gather_segments_kway`` body (plain columns).
    Input j's rows ``[starts[j], starts[j] + counts[j])`` of every buffer,
    a varlen column's elements over ``[offsets_j[starts[j]],
    offsets_j[starts[j] + counts[j]])``, offsets rebuilt from one int32
    cumsum of the packed row lengths.  The windows are host ints, so each
    row buffer (a varlen column's offsets too) is cut to its window
    first: the pack then reads only the piece's rows."""
    cut = [[(d, v[s:s + c], o[s:s + c + 1]) if o is not None
            else (d[s:s + c], v[s:s + c], None)
            for (d, v, o), s, c in zip(parts, starts, counts)]
           for parts in columns]
    return _pack_windows_reference(cut, [0] * len(starts), counts, out_cap,
                                   byte_caps)


def _pack_windows_reference(columns, starts, counts, out_cap, byte_caps):
    device = columns[0][0][1].device
    los = _index_vector(starts, device)
    his = los + _index_vector(counts, device)
    out = []
    var_i = 0
    for parts in columns:
        validity = pack_segments_reference([p[1] for p in parts], los, his,
                                           out_cap)
        if parts[0][2] is None:
            data = pack_segments_reference([p[0] for p in parts], los, his,
                                           out_cap)
            out.append((data, validity, None))
            continue
        offs = [p[2] for p in parts]
        lens = pack_segments_reference([o[1:] - o[:-1] for o in offs],
                                       los, his, out_cap)
        offsets = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=lens.device),
            torch.cumsum(lens, 0, dtype=torch.int32)])
        data = pack_segments_reference(
            [p[0] for p in parts],
            [o[lo.long()] for o, lo in zip(offs, los.unbind())],
            [o[hi.long()] for o, hi in zip(offs, his.unbind())],
            byte_caps[var_i])
        var_i += 1
        out.append((data, validity, offsets))
    return out


#: a buffer whose int32 output is rebuilt string offsets, not a copy
#: (``kKindOffsets`` in pack_segments.cu)
_KIND_OFFSETS = 1
_pack_max_words = 0  # the library's kLargeWords, read at first launch


def _pack_max_inputs(n_sets: int) -> int:
    """Inputs per buffer that one launch's table holds with ``n_sets``
    window sets and one buffer (header 3 words, 4 per input and set, a
    buffer 4 + one per input)."""
    global _pack_max_words
    if not _pack_max_words:
        _pack_max_words = load("gatherScatter").srt_pack_max_words()
    return (_pack_max_words - 7) // (4 * n_sets + 1)


def _run_pack(desc, device: torch.device) -> None:
    """Launch gatherScatter over a table of int64 words (the layout in
    pack_segments.cu; a list or an int64 numpy array) and count its
    launches."""
    lib = load("gatherScatter")
    launches = ctypes.c_int(0)
    if isinstance(desc, np.ndarray):
        table = np.ascontiguousarray(desc, dtype=np.int64)
        address, words = table.ctypes.data, table.size
    else:
        table = array.array("q", desc)
        address, words = table.buffer_info()
    err = _launch(device, lib.srt_pack_multi, address, words,
                  ctypes.byref(launches))
    if err != 0:
        raise KernelLaunchError("gatherScatter", err)
    _launches["gatherScatter"] += launches.value


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
    if dtype.is_complex or a0.element_size() not in (1, 2, 4, 8):
        raise ValueError(f"pack_segments has no kernel for {dtype}")
    ptrs = _pointers("pack_segments", arrays, dtype, device.index)
    k = len(arrays)
    limit = _pack_max_inputs(1)
    if k > limit:
        # pack groups into intermediates, then pack the intermediates
        los_t = _index_vector(los, device)
        his_t = _index_vector(his, device)
        parts, totals = [], []
        for g in range(0, k, limit):
            sl = slice(g, g + limit)
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
    desc = [k, 1, 1]
    for lo, hi, n in zip(lo_ptrs, hi_ptrs, sizes):
        desc += (lo or 0, hi or 0, 0, n)
    desc += (out.data_ptr(), out_cap, a0.element_size(), 0)
    desc += ptrs
    _run_pack(desc, device)
    return out


def pack_columns(columns, num_rows, out_cap: int,
                 byte_caps: Sequence[int]) -> list:
    """Every buffer of a k-way concat of batches, in one gatherScatter
    launch: each column's validity and data, each string column's bytes
    and rebuilt offsets.

    ``columns`` holds, per column, the k batches' ``(data, validity,
    offsets)`` (offsets ``None`` for a fixed-width column); ``num_rows``
    the k batches' live-row counts as 0-d int32 tensors on the device;
    ``byte_caps`` each string column's output byte capacity, in column
    order.  Returns per column ``(data, validity, offsets)`` of capacity
    ``out_cap``: the live rows (and bytes) of the batches in order, zeros
    past the live totals, and offsets constant past the live rows.  String
    offsets start at 0.  CPU tensors take :func:`pack_columns_reference`;
    on CUDA the kernel reads each ``num_rows`` and each string's live byte
    end ``offsets[num_rows]`` itself: no host sync."""
    device = num_rows[0].device
    if device.type == "cpu":
        return pack_columns_reference(columns, num_rows, out_cap, byte_caps)
    if device.type != "cuda":
        raise ValueError(f"pack_columns has no kernel for {device}")
    if not 0 <= out_cap < 2 ** 31:
        raise ValueError(f"out_cap {out_cap} outside [0, 2^31)")
    k = len(num_rows)
    strings = [ci for ci, parts in enumerate(columns)
               if parts[0][2] is not None]
    if len(byte_caps) != len(strings):
        raise ValueError(f"pack_columns: {len(byte_caps)} byte capacities "
                         f"for {len(strings)} string columns")
    n_sets = 1 + len(strings)
    limit = _pack_max_inputs(n_sets)
    if k > limit:
        return _pack_columns_grouped(columns, num_rows, out_cap, byte_caps,
                                     limit)
    desc, out = _pack_columns_table(columns, num_rows, out_cap, byte_caps,
                                    device)
    _run_pack(desc, device)
    return out


def pack_column_windows(columns, starts, counts, out_cap: int,
                        byte_caps: Sequence[int], inputs=None) -> list:
    """Every buffer of k row windows of batches packed back to back, in one
    gatherScatter launch: the shuffle split's piece gather (the JAX
    package's ``layout.gather_segments_kway``).

    ``columns`` as :func:`pack_columns`; ``starts`` and ``counts`` host
    ints, input j's window its rows ``[starts[j], starts[j] +
    counts[j])``, which must lie within its live rows; ``byte_caps`` each
    varlen column's output element capacity.  A varlen column's elements
    are packed over ``[offsets_j[starts[j]], offsets_j[starts[j] +
    counts[j]])``: the kernel reads those two offsets itself, and rebases
    the window's offsets by the first.  ``inputs``, a :class:`PackInputs`
    of ``columns`` made once, spares a caller that packs many windows of
    the same batches the checks and addresses of every buffer (``columns``
    is then not read).  Returns per column ``(data, validity, offsets)``
    of capacity ``out_cap``, zeros past the live totals.  CPU tensors take
    :func:`pack_column_windows_reference`."""
    if inputs is None:
        inputs = PackInputs(columns)
    columns = None
    device = inputs.device
    k = len(starts)
    if len(counts) != k or len(inputs.caps) != k:
        raise ValueError("pack_column_windows needs one start and one count "
                         "per input of every column")
    for s, n, cap in zip(starts, counts, inputs.caps):
        if not 0 <= s <= s + n <= cap:
            raise ValueError(f"pack_column_windows: window [{s}, {s + n}) "
                             f"outside a batch of capacity {cap}")
    if device.type == "cpu":
        return pack_column_windows_reference(inputs.columns, starts, counts,
                                             out_cap, byte_caps)
    if device.type != "cuda":
        raise ValueError(f"pack_column_windows has no kernel for {device}")
    if not 0 <= out_cap < 2 ** 31:
        raise ValueError(f"out_cap {out_cap} outside [0, 2^31)")
    varlen = len(inputs.var_cols)
    if len(byte_caps) != varlen:
        raise ValueError(f"pack_column_windows: {len(byte_caps)} element "
                         f"capacities for {varlen} varlen columns")
    limit = _pack_max_inputs(1 + varlen)
    if k > limit:
        # pack groups of windows into intermediates, then concat them
        columns = inputs.columns
        groups, group_rows = [], []
        for g in range(0, k, limit):
            sl = slice(g, g + limit)
            cols = [parts[sl] for parts in columns]
            rows = sum(counts[sl])
            caps_g = [sum(int(d.shape[0]) for d, _, _ in parts)
                      for parts in cols if parts[0][2] is not None]
            groups.append(pack_column_windows(cols, starts[sl], counts[sl],
                                              max(rows, 1), caps_g))
            group_rows.append(torch.full((), rows, dtype=torch.int32,
                                         device=device))
        merged = [[g[ci] for g in groups] for ci in range(len(columns))]
        return pack_columns(merged, group_rows, out_cap, byte_caps)
    desc, out = _windows_table(inputs, starts, counts, out_cap, byte_caps)
    _run_pack(desc, device)
    return out


class PackInputs:
    """k batches' buffers checked once for gatherScatter's window packs:
    on CUDA the device address of every buffer of every input, in numpy
    arrays, so that a pack over a subset of the inputs (:meth:`take`)
    builds its launch table by array arithmetic.  The shuffle split packs
    one piece a target from the same sorted batches.  ``columns`` as
    :func:`pack_columns`."""

    def __init__(self, columns, _parent=None, _idx=None):
        if _parent is not None:  # a subset of the parent's inputs
            self._parent, self._idx = _parent, _idx
            self.device, self.var_cols = _parent.device, _parent.var_cols
            self.kinds = _parent.kinds
            self.caps = [_parent.caps[i] for i in _idx]
            if _parent.ptrs is not None:
                self.ptrs = _parent.ptrs[:, _idx]
                self.var_sizes = _parent.var_sizes[:, _idx]
                self.var_offs = _parent.var_offs[:, _idx]
                self.shifts, self.meta = _parent.shifts, _parent.meta
            else:
                self.ptrs = None
            self._columns = None
            return
        self._parent, self._columns = None, columns
        self.device = columns[0][0][1].device
        self.caps = [int(v.shape[0]) for _, v, _ in columns[0]]
        if any(len(parts) != len(self.caps) for parts in columns):
            raise ValueError("pack inputs: every column needs one buffer set "
                             "per input")
        #: per column, its data's dtype and whether it is varlen
        self.kinds = [(parts[0][0].dtype, parts[0][2] is not None)
                      for parts in columns]
        self.var_cols = [ci for ci, (_, var) in enumerate(self.kinds) if var]
        self.ptrs = None
        if self.device.type == "cuda":
            self._addresses(columns, self.device.index
                            if self.device.index is not None
                            else torch.cuda.current_device())

    def _addresses(self, columns, index: int) -> None:
        """Every buffer's checked address on device ``index``, and how a
        window moves it."""
        caps = self.caps
        # buffer rows in table order: each column's validity, data and (a
        # varlen column) offsets; shifts: bytes a window start moves the
        # input's address (a varlen column's elements move by its bounds)
        ptrs, shifts, meta, var_offs, var_sizes = [], [], [], [], []
        for parts in columns:
            data0, _, offs0 = parts[0]
            ptrs.append(_pointers("pack_columns", [v for _, v, _ in parts],
                                  torch.bool, index, caps))
            shifts.append(1)
            meta.append(1)
            if data0.dtype.is_complex or \
                    data0.element_size() not in (1, 2, 4, 8):
                raise ValueError(
                    f"pack_columns has no kernel for {data0.dtype}")
            width = data0.element_size()
            if offs0 is None:
                ptrs.append(_pointers("pack_columns",
                                      [d for d, _, _ in parts],
                                      data0.dtype, index, caps))
                shifts.append(width)
                meta.append(width)
                continue
            offs = _pointers("pack_columns", [o for _, _, o in parts],
                             torch.int32, index, [c + 1 for c in caps])
            ptrs.append(_pointers("pack_columns", [d for d, _, _ in parts],
                                  data0.dtype, index))
            shifts.append(0)
            meta.append(width | (len(var_offs) + 1) << 16)
            ptrs.append(offs)
            shifts.append(4)
            meta.append(4 | _KIND_OFFSETS << 8)
            var_offs.append(offs)
            var_sizes.append([int(d.shape[0]) for d, _, _ in parts])
        k = len(caps)
        self.ptrs = np.array(ptrs, dtype=np.int64).reshape(-1, k)
        self.shifts = np.array(shifts, dtype=np.int64)
        self.meta = np.array(meta, dtype=np.int64)
        self.var_offs = np.array(var_offs, dtype=np.int64).reshape(-1, k)
        self.var_sizes = np.array(var_sizes, dtype=np.int64).reshape(-1, k)

    @property
    def columns(self):
        """The inputs' ``(data, validity, offsets)`` per column."""
        if self._columns is None:
            self._columns = [[parts[i] for i in self._idx]
                             for parts in self._parent.columns]
        return self._columns

    def take(self, idx: Sequence[int]) -> "PackInputs":
        """The inputs ``idx``, in that order."""
        return PackInputs(None, self, list(idx))


def _windows_table(inputs: PackInputs, starts, counts, out_cap: int,
                   byte_caps):
    """gatherScatter's launch table for :func:`pack_column_windows` (an
    int64 numpy array) and the outputs it writes.  A row window needs no
    bound on the device: its row buffers' addresses move to the window's
    first row and its count is the input's size.  A varlen window's
    element bounds are the addresses of its two offsets, which the kernel
    reads itself."""
    device = inputs.device
    st = np.asarray(starts, dtype=np.int64)
    ct = np.asarray(counts, dtype=np.int64)
    k = len(st)
    n_var = len(inputs.var_cols)
    sets = np.zeros((1 + n_var, k, 4), dtype=np.int64)
    sets[0, :, 3] = ct  # set 0: the row windows
    sets[1:, :, 0] = inputs.var_offs + 4 * st  # lo offsets[start]
    sets[1:, :, 1] = inputs.var_offs + 4 * (st + ct)  # hi offsets[end]
    sets[1:, :, 3] = inputs.var_sizes
    n_buf = len(inputs.meta)
    bufs = np.empty((n_buf, 4 + k), dtype=np.int64)
    bufs[:, 4:] = inputs.ptrs + inputs.shifts[:, None] * st
    bufs[:, 2] = inputs.meta
    bufs[:, 3] = 0
    out, addr, elems = [], [], []
    var_i = 0
    for dtype, is_var in inputs.kinds:
        validity = torch.empty(out_cap, dtype=torch.bool, device=device)
        if not is_var:
            data = torch.empty(out_cap, dtype=dtype, device=device)
            addr += (validity.data_ptr(), data.data_ptr())
            elems += (out_cap, out_cap)
            out.append((data, validity, None))
            continue
        cap = byte_caps[var_i]
        var_i += 1
        data = torch.empty(cap, dtype=dtype, device=device)
        offsets = torch.empty(out_cap + 1, dtype=torch.int32, device=device)
        addr += (validity.data_ptr(), data.data_ptr(), offsets.data_ptr())
        elems += (out_cap, cap, out_cap + 1)
        out.append((data, validity, offsets))
    bufs[:, 0] = addr
    bufs[:, 1] = elems
    desc = np.concatenate([np.array([k, 1 + n_var, n_buf], dtype=np.int64),
                           sets.reshape(-1), bufs.reshape(-1)])
    return desc, out


def _pointers(fn: str, tensors, dtype, index: int, lengths=None) -> list:
    """Device addresses of ``tensors`` after the checks the kernel needs:
    ``dtype``, contiguous, on device ``index`` and, where ``lengths`` is
    given, that many elements each (one pass: a concat checks hundreds)."""
    out = []
    for t, n in zip(tensors, lengths or [None] * len(tensors)):
        if t.dtype != dtype or (n is not None and t.numel() != n) or \
                not t.is_contiguous() or t.get_device() != index:
            raise ValueError(
                f"{fn}: expected contiguous {dtype} buffers on device "
                f"{index}" + ("" if n is None else f" of {n} elements") +
                f", got {t.dtype} {tuple(t.shape)} on {t.device}")
        out.append(t.data_ptr())
    return out


def _pack_columns_table(columns, num_rows, out_cap, byte_caps, device):
    """gatherScatter's launch table (the int64 words of pack_segments.cu's
    layout) for :func:`pack_columns` and the outputs it writes: the
    windows ``[0, num_rows[j])``, bounds read on the device, a string's
    byte window ending at ``offsets[num_rows[j]]``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    caps = [int(v.shape[0]) for _, v, _ in columns[0]]
    ns = []
    for n in num_rows:
        if n.numel() != 1 or n.get_device() != index:
            raise ValueError(
                f"pack_columns: num_rows must be scalars on {device}, "
                f"got {tuple(n.shape)} on {n.device}")
        if n.dtype != torch.int32:  # freed in stream order, after the read
            n = n.to(torch.int32)
        ns.append(n.data_ptr())
    varlen = [parts for parts in columns if parts[0][2] is not None]
    desc = [len(caps), 1 + len(varlen), 2 * len(columns) + len(varlen)]
    for n, cap in zip(ns, caps):  # set 0: the row windows
        desc += (0, n, 0, cap)
    for parts in varlen:  # set 1 + s: string column s's byte windows
        offs = _pointers("pack_columns", [o for _, _, o in parts],
                         torch.int32, index, [c + 1 for c in caps])
        for n, (d, _, _), o in zip(ns, parts, offs):
            desc += (0, n, o, d.shape[0])  # lo 0, hi offsets[num_rows]
    out = []
    var_i = 0
    for parts in columns:
        data0, _, offs0 = parts[0]
        validity = torch.empty(out_cap, dtype=torch.bool, device=device)
        desc += (validity.data_ptr(), out_cap, 1, 0)
        desc += _pointers("pack_columns", [v for _, v, _ in parts],
                          torch.bool, index, caps)
        if data0.dtype.is_complex or \
                data0.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"pack_columns has no kernel for {data0.dtype}")
        width = data0.element_size()
        if offs0 is None:
            data = torch.empty(out_cap, dtype=data0.dtype, device=device)
            desc += (data.data_ptr(), out_cap, width, 0)
            desc += _pointers("pack_columns", [d for d, _, _ in parts],
                              data0.dtype, index, caps)
            out.append((data, validity, None))
            continue
        var_i += 1
        data = torch.empty(byte_caps[var_i - 1], dtype=data0.dtype,
                           device=device)
        desc += (data.data_ptr(), byte_caps[var_i - 1],
                 width | var_i << 16, 0)
        desc += _pointers("pack_columns", [d for d, _, _ in parts],
                          data0.dtype, index)
        offsets = torch.empty(out_cap + 1, dtype=torch.int32, device=device)
        desc += (offsets.data_ptr(), out_cap + 1, 4 | _KIND_OFFSETS << 8, 0)
        desc += [o.data_ptr() for _, _, o in parts]
        out.append((data, validity, offsets))
    return desc, out


def _pack_columns_grouped(columns, num_rows, out_cap, byte_caps, limit):
    """:func:`pack_columns` of more batches than one launch's table holds:
    concat groups of ``limit`` batches into intermediates (capacities the
    sums of their inputs'), then concat the intermediates.  Concatenation
    is associative, so the buffers are the one-launch result's."""
    groups, group_rows = [], []
    for g in range(0, len(num_rows), limit):
        sl = slice(g, g + limit)
        cols = [parts[sl] for parts in columns]
        caps = [int(v.shape[0]) for _, v, _ in cols[0]]
        bcaps = [sum(int(d.shape[0]) for d, _, _ in parts)
                 for parts in cols if parts[0][2] is not None]
        groups.append(pack_columns(cols, num_rows[sl], sum(caps), bcaps))
        group_rows.append(torch.stack(list(num_rows[sl])).sum()
                          .to(torch.int32))
    merged = [[g[ci] for g in groups] for ci in range(len(columns))]
    return pack_columns(merged, group_rows, out_cap, byte_caps)


# ---------------------------------------------------------------------------
# stringHash and strings (contains): per-row work over a string column
# ---------------------------------------------------------------------------


def _check_string_column(fn: str, data: torch.Tensor,
                         offsets: torch.Tensor, device: torch.device) -> int:
    """Every check a string kernel's input needs, once; returns the
    column's capacity.  Contiguity matters only to a kernel."""
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"{fn}: data must be a 1-D uint8 byte buffer, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if offsets.dim() != 1 or offsets.dtype != torch.int32 or \
            offsets.shape[0] < 1:
        raise ValueError(f"{fn}: offsets must be 1-D int32[cap+1], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if data.device != device or offsets.device != device:
        raise ValueError(f"{fn}: data on {data.device}, offsets on "
                         f"{offsets.device}, expected {device}")
    if device.type != "cpu" and not (data.is_contiguous() and
                                     offsets.is_contiguous()):
        raise ValueError(f"{fn} inputs must be contiguous")
    return int(offsets.shape[0]) - 1


def _checked_cuda(fn: str, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn} has no kernel for {device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{fn} inputs must be contiguous")


def rows_of_positions(offsets: torch.Tensor, nbytes: int,
                      start: int = 0) -> torch.Tensor:
    """int32[nbytes]: the row owning each byte position from ``start``
    on (cap for bytes past ``offsets[-1]``), one ``searchsorted`` over the
    offsets."""
    pos = torch.arange(start, start + nbytes, dtype=torch.int32,
                       device=offsets.device)
    return torch.searchsorted(offsets[1:].contiguous(), pos, right=True,
                              out_int32=True)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for u32 values held in int64, split into 16-bit
    halves of ``a`` so that no product leaves int64's range."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _pow_table(base: int, n: int, device) -> torch.Tensor:
    """int64[n+1]: ``base^k mod 2^32`` for k in [0, n], by binary
    exponentiation (one multiply per bit of k)."""
    k = torch.arange(n + 1, dtype=torch.int64, device=device)
    out = torch.ones(n + 1, dtype=torch.int64, device=device)
    sq = base & _M32
    for j in range(max(n, 1).bit_length()):
        bit = ((k >> j) & 1) == 1
        out = _mul32(out, torch.where(bit, sq, 1))
        sq = (sq * sq) & _M32
    return out


#: bytes the plain string hash weighs at once, so its int64 temporaries
#: stay near 2 GB whatever the column's size
HASH_BYTES_CHUNK = 1 << 26


def string_hash_rows_reference(data: torch.Tensor, offsets: torch.Tensor
                               ) -> tuple:
    """Plain PyTorch dual row hashes: the port of the JAX package's XLA
    formulation in ``exprs/strings.py`` ``string_hash2``.  Each byte
    contributes ``byte * base^(end-1-pos)`` to its row (a weighted
    segment sum, ``HASH_BYTES_CHUNK`` bytes at a time; bytes past
    ``offsets[-1]`` belong to no row), then the row's length times
    ``0x9E3779B9`` is added, all mod 2^32.  Returns (h1, h2), int64[cap]
    holding u32 values."""
    cap = int(offsets.numel()) - 1
    nbytes = int(data.numel())
    device = data.device
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64) & _M32
    mix = _mul32(lens, HASH_GOLDEN)
    if cap < 1 or nbytes < 1:
        return mix, mix.clone()
    live = max(min(nbytes, int(offsets[-1])), 0)
    # a byte's exponent is under its row's length
    top = max(min(int((offsets[1:] - offsets[:-1]).max()), live), 0)
    tables = [_pow_table(base, top, device) for base in HASH_BASES]
    hs = [torch.zeros(cap, dtype=torch.int64, device=device)
          for _ in HASH_BASES]
    for b0 in range(0, live, HASH_BYTES_CHUNK):
        n = min(HASH_BYTES_CHUNK, live - b0)
        rows_c = rows_of_positions(offsets, n, start=b0).clamp(
            0, cap - 1).long()
        pos = torch.arange(b0, b0 + n, dtype=torch.int64, device=device)
        exp = (offsets[rows_c + 1].long() - 1 - pos).clamp(0, top)
        byte = data[b0:b0 + n].long()
        for h, table in zip(hs, tables):
            h.index_add_(0, rows_c, (byte * table[exp]) & _M32)
    return (hs[0] + mix) & _M32, (hs[1] + mix) & _M32


def string_hash_columns_reference(columns) -> list:
    """Plain version of :func:`string_hash_columns`: one
    :func:`string_hash_rows_reference` per column."""
    return [string_hash_rows_reference(d, o) for d, o in columns]


def string_hash_columns(columns) -> list:
    """Dual 32-bit polynomial hashes (bases 31 and 131) of every row of
    each string column, each plus ``len * 0x9E3779B9``, mod 2^32.

    ``columns`` is a sequence of ``(data, offsets)`` pairs on one device:
    the u8 byte buffer and the int32[cap+1] row offsets.  Returns one
    ``(h1, h2)`` pair per column, int64[cap] holding u32 values (the form
    of the port's sort words).  CPU tensors take
    :func:`string_hash_columns_reference`; on CUDA every column goes into
    ONE launch (its table is a kernel parameter), which reads the offsets
    itself: no host sync.  All the hashes are views of one allocation."""
    columns = list(columns)
    if not columns:
        return []
    device = columns[0][0].device
    caps = [_check_string_column("string_hash_columns", d, o, device)
            for d, o in columns]
    if device.type == "cpu":
        return string_hash_columns_reference(columns)
    if device.type != "cuda":
        raise ValueError(f"string_hash_columns has no kernel for {device}")
    out = torch.empty(2 * sum(caps), dtype=torch.int64, device=device)
    words = out.split([cap for cap in caps for _ in (0, 1)])
    hashes = list(zip(words[::2], words[1::2]))
    at, base = 0, out.data_ptr()
    desc = [len(columns)]
    for (data, offsets), cap in zip(columns, caps):
        desc += (data.data_ptr(), data.shape[0], offsets.data_ptr(), cap,
                 base + 8 * at, base + 8 * (at + cap))
        at += 2 * cap
    if at == 0:
        return hashes
    table = array.array("q", desc)
    launches = ctypes.c_int(0)
    err = _launch(device, load("stringHash").srt_string_hash_columns,
                  table.buffer_info()[0], len(table), HASH_BASES[0],
                  HASH_BASES[1], HASH_GOLDEN, ctypes.byref(launches))
    if err != 0:
        raise KernelLaunchError("stringHash", err)
    _launches["stringHash"] += launches.value
    return hashes


def string_hash_rows(data: torch.Tensor, offsets: torch.Tensor) -> tuple:
    """:func:`string_hash_columns` of one column: (h1, h2), int64[cap]
    holding u32 values.  CPU tensors take
    :func:`string_hash_rows_reference`."""
    return string_hash_columns([(data, offsets)])[0]


def _find_matches(data: torch.Tensor, offsets: torch.Tensor,
                 needle: bytes) -> torch.Tensor:
    """bool[nbytes]: a match of ``needle`` (non-empty) starts at this
    byte position and ends inside the row owning it (the JAX package's
    ``exprs/strings.py`` ``_find_matches``)."""
    cap = int(offsets.numel()) - 1
    nbytes = int(data.numel())
    rows_c = rows_of_positions(offsets, nbytes).clamp(0, cap - 1).long()
    ends = offsets[rows_c + 1]
    pos = torch.arange(nbytes, dtype=torch.int32, device=data.device)
    match = (pos + len(needle)) <= ends
    for k, b in enumerate(needle):
        idx = (pos + k).clamp(0, nbytes - 1).long()
        match = match & (data[idx] == b)
    return match


def rows_with_match_reference(data: torch.Tensor, offsets: torch.Tensor,
                              needle: bytes) -> torch.Tensor:
    """Plain PyTorch contains scan: the port of the JAX package's XLA
    formulation (``exprs/strings.py`` ``_rows_with_match``): per-byte
    matches, segment-summed per owning row."""
    cap = int(offsets.numel()) - 1
    nbytes = int(data.numel())
    if len(needle) == 0:
        return torch.ones(cap, dtype=torch.bool, device=data.device)
    counts = torch.zeros(cap, dtype=torch.int32, device=data.device)
    if cap < 1 or nbytes < 1:
        return counts > 0
    rows_c = rows_of_positions(offsets, nbytes).clamp(0, cap - 1).long()
    counts.index_add_(0, rows_c,
                      _find_matches(data, offsets, needle).to(torch.int32))
    return counts > 0


def _device_needle(needle: bytes, device: torch.device) -> torch.Tensor:
    """The needle's bytes on ``device``, copied there once per needle and
    device, so a scan makes no host-to-device copy."""
    key = (needle, device.index)
    t = _needles.get(key)
    if t is None:
        t = torch.frombuffer(bytearray(needle), dtype=torch.uint8).to(device)
        _needles[key] = t
    return t


def rows_with_match(data: torch.Tensor, offsets: torch.Tensor,
                    needle: bytes) -> torch.Tensor:
    """bool[cap]: row r of the string column holds ``needle`` (a literal
    byte string).  An empty needle matches every row without a launch.
    CPU tensors take :func:`rows_with_match_reference`; CUDA tensors
    launch the kernel (one launch: tiles of rows staged in shared memory,
    match starts marked in a bitmap there, each row's bits ORed)."""
    device = data.device
    cap = _check_string_column("rows_with_match", data, offsets, device)
    needle = bytes(needle)
    if len(needle) == 0:
        return torch.ones(cap, dtype=torch.bool, device=device)
    if device.type == "cpu":
        return rows_with_match_reference(data, offsets, needle)
    if device.type != "cuda":
        raise ValueError(f"rows_with_match has no kernel for {device}")
    if len(needle) >= 2 ** 31:
        raise ValueError("rows_with_match: needle too long")
    out = torch.empty(cap, dtype=torch.bool, device=device)
    if cap == 0:
        return out
    err = _launch(device, load("strings").srt_contains,
                  data.data_ptr(), data.shape[0], offsets.data_ptr(), cap,
                  _device_needle(needle, device).data_ptr(), len(needle),
                  out.data_ptr())
    if err != 0:
        raise KernelLaunchError("strings (contains)", err)
    _launches["strings"] += 1
    return out


# ---------------------------------------------------------------------------
# joinProbe: the static join's candidate phase
# ---------------------------------------------------------------------------

def probe_join_reference(l_h1, l_mask, r_sorted, perm, a_words, a_valid,
                         b_words, b_valid, pair_cap: int) -> tuple:
    """Plain PyTorch candidate phase: the port of the JAX package's
    ``join_pairs_static.xla_candidates`` (``kernels/join.py``), with the
    exact-key test over the pre-encoded word matrices (word for word what
    ``_exact_eq`` compares).  Every gather index is clipped as the
    reference clips it, so lanes past the total carry the same rows."""
    l_cap, r_cap = int(l_h1.shape[0]), int(r_sorted.shape[0])
    lo = torch.searchsorted(r_sorted, l_h1, right=False).to(torch.int32)
    hi = torch.searchsorted(r_sorted, l_h1, right=True).to(torch.int32)
    counts = torch.where(l_mask, hi - lo, 0).to(torch.int32)
    total = counts.sum(dtype=torch.int64)
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = cum - counts
    k = torch.arange(pair_cap, dtype=torch.int32, device=l_h1.device)
    probe_row = torch.searchsorted(cum, k, right=True, out_int32=True)
    probe_row = probe_row.clamp(0, l_cap - 1)
    pr = probe_row.long()
    ordinal = k - starts[pr]
    build_row = perm[(lo[pr] + ordinal).clamp(0, r_cap - 1).long()]
    br = build_row.long()
    eq = a_valid[pr] & b_valid[br] & (a_words[:, pr] == b_words[:, br]).all(0)
    match = (k < torch.clamp(total, max=pair_cap)) & eq
    return probe_row, build_row, match, total


def _check_probe_inputs(l_h1, l_mask, r_sorted, perm, a_words, a_valid,
                        b_words, b_valid, pair_cap: int) -> None:
    l_cap, r_cap = int(l_h1.shape[0]), int(r_sorted.shape[0])
    want = {"l_h1": (l_h1, torch.int64, (l_cap,)),
            "l_mask": (l_mask, torch.bool, (l_cap,)),
            "r_sorted": (r_sorted, torch.int64, (r_cap,)),
            "perm": (perm, torch.int32, (r_cap,)),
            "a_valid": (a_valid, torch.bool, (l_cap,)),
            "b_valid": (b_valid, torch.bool, (r_cap,))}
    n_words = int(a_words.shape[0]) if a_words.dim() == 2 else 0
    want["a_words"] = (a_words, torch.int64, (n_words, l_cap))
    want["b_words"] = (b_words, torch.int64, (n_words, r_cap))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"probe_join: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != l_h1.device:
            raise ValueError(f"probe_join: {name} on {t.device}, l_h1 on "
                             f"{l_h1.device}")
    if n_words < 1 or l_cap < 1 or r_cap < 1:
        raise ValueError("probe_join needs at least one key word and one "
                         "row on each side")
    if not 0 < pair_cap < 2 ** 31 or max(l_cap, r_cap) >= 2 ** 31:
        raise ValueError(f"probe_join: pair_cap {pair_cap} or capacities "
                         "outside [1, 2^31)")


def probe_join(l_h1, l_mask, r_sorted, perm, a_words, a_valid, b_words,
               b_valid, pair_cap: int) -> tuple:
    """The candidate phase of the static equi-join: for ``pair_cap`` pair
    slots, the probe row, build row and exact-match flag of every
    candidate whose first key hash equals, and the candidate total.

    ``l_h1`` int64[l_cap] probe hashes (u32 values), ``l_mask``
    bool[l_cap] live rows with valid keys, ``r_sorted`` int64[r_cap]
    build hashes in ascending order, ``perm`` int32[r_cap] the build rows
    in that order, ``a_words``/``b_words`` int64[W, cap] key words (u32
    values) and ``a_valid``/``b_valid`` bool[cap].  Returns ``(probe_row
    int32[pair_cap], build_row int32[pair_cap], match bool[pair_cap],
    total int64)``; ``probe_row`` is sorted.  CPU tensors take
    :func:`probe_join_reference`; CUDA tensors launch the kernel (two
    launches, no host sync: ``total`` stays on the device; the outputs are
    views of one workspace allocation that also holds the scratch)."""
    _check_probe_inputs(l_h1, l_mask, r_sorted, perm, a_words, a_valid,
                        b_words, b_valid, pair_cap)
    if l_h1.device.type == "cpu":
        return probe_join_reference(l_h1, l_mask, r_sorted, perm, a_words,
                                    a_valid, b_words, b_valid, pair_cap)
    inputs = (l_h1, l_mask, r_sorted, perm, a_words, a_valid, b_words,
              b_valid)
    _checked_cuda("probe_join", *inputs)
    device = l_h1.device
    l_cap, r_cap = int(l_h1.shape[0]), int(r_sorted.shape[0])
    lib = load("joinProbe")
    at = (ctypes.c_longlong * 4)()
    nbytes = lib.srt_probe_join_workspace(l_cap, r_cap, pair_cap, at)
    # one allocation: the outputs, then the kernel's scratch
    ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
    words = ws.view(torch.int32)  # every offset is 256-byte aligned
    probe_row = words[at[0] // 4:at[0] // 4 + pair_cap]
    build_row = words[at[1] // 4:at[1] // 4 + pair_cap]
    match = ws[at[2]:at[2] + pair_cap].view(torch.bool)
    total = ws.view(torch.int64)[at[3] // 8]
    err = _launch(device, lib.srt_probe_join,
                  l_h1.data_ptr(), l_mask.data_ptr(), l_cap,
                  r_sorted.data_ptr(), perm.data_ptr(), r_cap,
                  a_words.data_ptr(), a_valid.data_ptr(), b_words.data_ptr(),
                  b_valid.data_ptr(), int(a_words.shape[0]), pair_cap,
                  ws.data_ptr())
    if err != 0:
        raise KernelLaunchError("joinProbe", err)
    _launches["joinProbe"] += 1
    return probe_row, build_row, match, total
