"""Equi-join kernels (port of ``spark_rapids_tpu/kernels/join.py``).

No hash table: the build side is sorted by a pair of 32-bit key hashes;
each probe row finds its candidate range on the first hash with two binary
searches, and every candidate is verified by exact key comparison.  The
output size depends on the data, so there are two forms:

* host-driven (:func:`join_pairs`, :func:`hash_join`): the pair total is
  read on the host (one sync) and sizes the pair list exactly; plain torch
  ops, the port of the JAX package's plain-XLA path;
* static (:func:`join_pairs_static`, :func:`hash_join_static`): the pair
  capacity is chosen up front from the probe capacity, the candidate phase
  is the **joinProbe** kernel (:func:`cuda_tier.probe_join`), and an
  overflow flag stays on the device for the caller to read once.

NULL keys never match (SQL semantics), NULL = NULL included.  u32 hashes
and key words are held in int64 tensors, as everywhere in the port, and
every multiply wraps mod 2^32 through ``cuda_tier._mul32``.  Every gather
index is clipped as the JAX package's ``jnp.clip`` calls clip it: a CUDA
gather with a bad index kills the context where ``jnp`` clamps.

Not ported yet: dictionary-encoded keys (``align_dict_codes`` and the
``codes`` branches), residual conditions (``_filter_pairs``), cross and
nested-loop joins.
"""

from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, DeviceColumn, round_up_capacity,
)
from spark_rapids_tpu_torch.exprs.base import DevVal
from spark_rapids_tpu_torch.exprs.strings import string_hash2, string_lengths
from spark_rapids_tpu_torch.kernels import cuda_tier
from spark_rapids_tpu_torch.kernels.cuda_tier import _mul32
from spark_rapids_tpu_torch.kernels.layout import (
    compaction_indices, gather_rows,
)
from spark_rapids_tpu_torch.kernels.sortkeys import (
    DEFAULT_STRING_PREFIX_BYTES, _encode_fixed_words, string_prefix_words,
)

_M32 = 0xFFFFFFFF
_SIGN32 = 1 << 31
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
SENTINEL = _M32  # the hash of a row with a NULL key: sorts last


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One murmur3-style mixing round of u32 word ``w`` into ``h``."""
    k = _rotl32(_mul32(w, _C1), 15)
    h = _rotl32(h ^ _mul32(k, _C2), 13)
    return (h * 5 + 0xE6546B64) & _M32


def _key_words(v: DevVal) -> List[torch.Tensor]:
    """The u32 words one key column mixes into the two hashes."""
    if v.dtype.is_string:
        s1, s2 = string_hash2(v)
        return [s1, s2, string_lengths(v).to(torch.int64) & _M32]
    return _encode_fixed_words(v)


def _key_hash2(vals: List[DevVal]):
    """(h1, h2, all_valid) over the key columns: two independent u32 hashes
    (int64[cap]) and bool[cap].  The build side sorts by (h1, h2); probes
    range-scan on h1 and verify exactly.  Rows with any NULL key get the
    sentinel ``0xFFFFFFFF`` in both hashes (never matched)."""
    cap = int(vals[0].validity.shape[0])
    dev = vals[0].validity.device
    h1 = torch.full((cap,), 0x12345678, dtype=torch.int64, device=dev)
    h2 = torch.full((cap,), 0x9E3779B9, dtype=torch.int64, device=dev)
    ok = torch.ones(cap, dtype=torch.bool, device=dev)
    for v in vals:
        ok = ok & v.validity
        for w in _key_words(v):
            h1 = _mix32(h1, w)
            h2 = _mix32(h2, w ^ 0xA5A5A5A5)
    return (torch.where(ok, h1, SENTINEL), torch.where(ok, h2, SENTINEL), ok)


def _exact_value_words(v: DevVal) -> List[torch.Tensor]:
    """The u32 words (int64) whose equality is key equality for one
    column: fixed-width order words, or a string's length, both hashes and
    64-byte prefix words."""
    if v.dtype.is_string:
        s1, s2 = string_hash2(v)
        return ([string_lengths(v).to(torch.int64) & _M32, s1, s2] +
                string_prefix_words(v, DEFAULT_STRING_PREFIX_BYTES))
    return _encode_fixed_words(v)


def _exact_eq(a_vals: List[DevVal], a_idx: torch.Tensor,
              b_vals: List[DevVal], b_idx: torch.Tensor) -> torch.Tensor:
    """Exact key equality of gathered index pairs, both sides valid.  A
    false match of strings needs both 32-bit hashes to collide with equal
    lengths and equal 64-byte prefixes."""
    a_idx, b_idx = a_idx.long(), b_idx.long()
    eq = torch.ones(a_idx.shape, dtype=torch.bool, device=a_idx.device)
    for va, vb in zip(a_vals, b_vals):
        eq = eq & va.validity[a_idx] & vb.validity[b_idx]
        for wa, wb in zip(_exact_value_words(va), _exact_value_words(vb)):
            eq = eq & (wa[a_idx] == wb[b_idx])
    return eq


def _exact_words(vals: List[DevVal]):
    """One side's key columns as a word matrix and combined validity:
    ``(words int64[W, cap], valid bool[cap])``, word for word what
    :func:`_exact_eq` compares, so ``valid[a] & valid[b] &
    all(words_a[:, a] == words_b[:, b])`` equals ``_exact_eq`` at any
    pair.  The layout joinProbe verifies candidates against."""
    valid = vals[0].validity
    words: List[torch.Tensor] = []
    for v in vals:
        valid = valid & v.validity
        words += _exact_value_words(v)
    return torch.stack(words), valid


def _exact_word_count(vals: List[DevVal]) -> int:
    """W of :func:`_exact_words` from the types alone: a DOUBLE is two
    words here (its bits), where the TPU encodes it in three."""
    n = 0
    for v in vals:
        if v.dtype.is_string:
            n += 3 + (DEFAULT_STRING_PREFIX_BYTES + 3) // 4
        elif v.dtype in (T.LONG, T.TIMESTAMP, T.DOUBLE):
            n += 2
        else:
            n += 1
    return n


def _phase1(probe_h1, probe_ok, probe_live, build_sorted_h1):
    """(lo int32, counts int32, total int64): each probe row's candidate
    range on h1 in the sorted build hashes (h2 and the exact keys are
    verified later).  ``total`` is int64, the JAX package's ``jnp.sum`` of
    int32 counts under x64."""
    lo = torch.searchsorted(build_sorted_h1, probe_h1, right=False)
    hi = torch.searchsorted(build_sorted_h1, probe_h1, right=True)
    counts = torch.where(probe_ok & probe_live, hi - lo, 0).to(torch.int32)
    return lo.to(torch.int32), counts, counts.sum(dtype=torch.int64)


def _build_sort(h1: torch.Tensor, h2: torch.Tensor):
    """(perm int32, sorted h1): the stable order of the build rows by
    (h1, h2).  The pair packs into one signed int64 as ``(h1 - 2^31) *
    2^32 + h2``, which orders as the unsigned pair does (the sentinel
    ``0xFFFFFFFF`` last)."""
    key = (h1 - _SIGN32) * (1 << 32) + h2
    _, perm = torch.sort(key, stable=True)
    return perm.to(torch.int32), h1[perm]


def _live(cap: int, num_rows, device) -> torch.Tensor:
    return torch.arange(cap, dtype=torch.int32, device=device) < num_rows


def _hashed_sides(left_keys, left_num_rows, right_keys, right_num_rows):
    """Both sides' hashes, the probe mask and the sorted build side."""
    l_cap = int(left_keys[0].validity.shape[0])
    r_cap = int(right_keys[0].validity.shape[0])
    dev = left_keys[0].validity.device
    l_live = _live(l_cap, left_num_rows, dev)
    r_live = _live(r_cap, right_num_rows, dev)
    l_h1, _l_h2, l_ok = _key_hash2(left_keys)
    r_h1, r_h2, r_ok = _key_hash2(right_keys)
    r_h1 = torch.where(r_live & r_ok, r_h1, SENTINEL)
    perm, r_sorted = _build_sort(r_h1, r_h2)
    return l_h1, l_ok, l_live, perm, r_sorted


def _compact_pairs(probe_row, build_row, match, l_cap: int, r_cap: int):
    """The shared tail: matched pairs stably first, their count, and the
    per-left-row match counts and right-matched flags outer joins need."""
    _, order = torch.sort(torch.where(match, 0, 1).to(torch.int32),
                          stable=True)
    n_pairs = match.sum(dtype=torch.int32)
    l_idx = probe_row[order].to(torch.int32)
    r_idx = build_row[order].to(torch.int32)
    ones = match.to(torch.int32)
    l_counts = torch.zeros(l_cap, dtype=torch.int32, device=match.device)
    l_counts.index_add_(0, probe_row.long(), ones)
    r_hits = torch.zeros(r_cap, dtype=torch.int32, device=match.device)
    r_hits.scatter_reduce_(0, build_row.long(), ones, "amax")
    return l_idx, r_idx, n_pairs, l_counts, r_hits > 0


def join_pairs(left_keys: List[DevVal], left_num_rows,
               right_keys: List[DevVal], right_num_rows):
    """Matching (left, right) row pairs, host-driven.

    Returns ``(l_idx int32[pair_cap], r_idx int32[pair_cap], n_pairs int32,
    l_counts int32[l_cap], r_matched bool[r_cap])``, pairs compacted to the
    front in probe order.  One host sync: the candidate total, which sizes
    ``pair_cap`` exactly."""
    l_cap = int(left_keys[0].validity.shape[0])
    r_cap = int(right_keys[0].validity.shape[0])
    dev = left_keys[0].validity.device
    l_h1, l_ok, l_live, perm, r_sorted = _hashed_sides(
        left_keys, left_num_rows, right_keys, right_num_rows)
    lo, counts, total = _phase1(l_h1, l_ok, l_live, r_sorted)

    pair_cap = round_up_capacity(max(int(total), 1))
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = cum - counts
    k = torch.arange(pair_cap, dtype=torch.int32, device=dev)
    probe_row = torch.searchsorted(cum, k, right=True, out_int32=True)
    probe_row = probe_row.clamp(0, l_cap - 1).long()
    ordinal = k - starts[probe_row]
    build_pos = (lo[probe_row] + ordinal).clamp(0, r_cap - 1).long()
    build_row = perm[build_pos]
    match = (k < total) & _exact_eq(left_keys, probe_row, right_keys,
                                    build_row)
    return _compact_pairs(probe_row, build_row, match, l_cap, r_cap)


def join_pairs_static(left_keys: List[DevVal], left_num_rows,
                      right_keys: List[DevVal], right_num_rows,
                      pair_cap: int):
    """:func:`join_pairs` at a pair capacity the caller chose, with no host
    sync: the candidate phase is the joinProbe kernel.

    Returns ``(l_idx, r_idx, n_pairs, l_counts, r_matched, overflow)``,
    ``overflow`` a 0-d bool on the device: the true candidate total
    exceeded ``pair_cap``, the pair list is truncated and the caller must
    rerun host-driven."""
    l_cap = int(left_keys[0].validity.shape[0])
    r_cap = int(right_keys[0].validity.shape[0])
    l_h1, l_ok, l_live, perm, r_sorted = _hashed_sides(
        left_keys, left_num_rows, right_keys, right_num_rows)
    a_words, a_valid = _exact_words(left_keys)
    b_words, b_valid = _exact_words(right_keys)
    probe_row, build_row, match, total = cuda_tier.probe_join(
        l_h1, l_ok & l_live, r_sorted, perm, a_words, a_valid, b_words,
        b_valid, pair_cap)
    overflow = total > pair_cap
    return _compact_pairs(probe_row, build_row, match, l_cap, r_cap) + \
        (overflow,)


# ---------------------------------------------------------------------------
# output stitching
# ---------------------------------------------------------------------------


def _string_lens(c: DeviceColumn) -> torch.Tensor:
    return (c.offsets[1:] - c.offsets[:-1]).to(torch.int64)


def _needed_bytes(batch: ColumnBatch, indices, live) -> List[torch.Tensor]:
    """Per-string-column byte totals (0-d int64 on the device) a gather
    at ``indices`` needs."""
    idx = indices.long().clamp(0, batch.capacity - 1)
    return [torch.where(live, _string_lens(c)[idx], 0).sum()
            for c in batch.columns if c.is_varlen]


def _string_byte_caps(batch: ColumnBatch, indices, live) -> List[int]:
    """Output byte capacities of the string columns of a gather at
    ``indices``, read on the host: one sync for all columns."""
    needs = _needed_bytes(batch, indices, live)
    if not needs:
        return []
    return [round_up_capacity(int(n), minimum=16)
            for n in torch.stack(needs).tolist()]


def _static_byte_caps(batch: ColumnBatch, growth: float,
                      out_cap: int = 0) -> List[int]:
    """Output byte capacities chosen without a sync: input bytes times
    ``growth`` times the row expansion ``out_cap / capacity`` (a join can
    repeat one side's rows up to the pair count)."""
    expand = max(1.0, out_cap / batch.capacity) if out_cap else 1.0
    return [round_up_capacity(
        max(int(int(c.data.shape[0]) * growth * expand), 1), minimum=16)
        for c in batch.columns if c.is_varlen]


def _caps_overflow(needs: List[torch.Tensor], caps: List[int],
                   device) -> torch.Tensor:
    """0-d bool: some needed byte total exceeds its capacity (the gather
    would silently truncate the bytes past it)."""
    ovf = torch.zeros((), dtype=torch.bool, device=device)
    for need, cap in zip(needs, caps):
        ovf = ovf | (need > cap)
    return ovf


def _semi_anti(left: ColumnBatch, l_counts, join_type: str) -> ColumnBatch:
    l_live = _live(left.capacity, left.num_rows, left.device)
    if join_type == "left_semi":
        mask = l_live & (l_counts > 0)
    else:
        mask = l_live & (l_counts == 0)
    idx, count = compaction_indices(mask, left.num_rows)
    return gather_rows(left, idx, count)


def _unmatched(left, right, l_counts, r_matched, join_type: str):
    """(un_l_mask, un_r_mask, n_un_l, n_un_r): the rows an outer join adds
    with the other side NULL (left/full: unmatched left rows; right/full:
    unmatched right rows)."""
    dev = left.device
    un_l = _live(left.capacity, left.num_rows, dev) & (l_counts == 0)
    un_r = _live(right.capacity, right.num_rows, dev) & ~r_matched
    if join_type not in ("left", "full"):
        un_l = torch.zeros_like(un_l)
    if join_type not in ("right", "full"):
        un_r = torch.zeros_like(un_r)
    return un_l, un_r, un_l.sum(dtype=torch.int32), \
        un_r.sum(dtype=torch.int32)


def _outer_indices(left, right, l_idx, r_idx, n_pairs, unmatched,
                   out_cap: int):
    """Row sources of an outer join's output: matched pairs, then the
    unmatched left rows, then the unmatched right rows; the other side of
    an unmatched row is NULL (index 0, validity masked).  Returns
    (li, l_valid, ri, r_valid, total)."""
    l_cap, r_cap = left.capacity, right.capacity
    pair_cap = int(l_idx.shape[0])
    un_l_mask, un_r_mask, n_un_l, n_un_r = unmatched
    total = n_pairs + n_un_l + n_un_r
    un_l_idx, _ = compaction_indices(un_l_mask, left.num_rows)
    un_r_idx, _ = compaction_indices(un_r_mask, right.num_rows)
    i = torch.arange(out_cap, dtype=torch.int32, device=left.device)
    in_pairs = i < n_pairs
    in_un_l = (i >= n_pairs) & (i < n_pairs + n_un_l)
    in_un_r = (i >= n_pairs + n_un_l) & (i < total)
    pair_i = i.clamp(0, pair_cap - 1).long()
    li = torch.where(in_pairs, l_idx[pair_i],
                     un_l_idx[(i - n_pairs).clamp(0, l_cap - 1).long()])
    l_valid = in_pairs | in_un_l
    li = torch.where(l_valid, li, 0)
    ri = torch.where(in_pairs, r_idx[pair_i],
                     un_r_idx[(i - n_pairs - n_un_l).clamp(
                         0, r_cap - 1).long()])
    r_valid = in_pairs | in_un_r
    ri = torch.where(r_valid, ri, 0)
    return li, l_valid, ri, r_valid, total


def _padded(batch: ColumnBatch, valid: torch.Tensor) -> List[DeviceColumn]:
    return [DeviceColumn(c.dtype, c.data, c.validity & valid, c.offsets)
            for c in batch.columns]


def stitch_join_output(left: ColumnBatch, right: ColumnBatch, l_idx, r_idx,
                       n_pairs, l_counts, r_matched, join_type: str,
                       out_schema: T.Schema) -> ColumnBatch:
    """The joined batch from matched pair indices, sized exactly on the
    host (one sync for the outer total, one for the string byte caps)."""
    pair_cap = int(l_idx.shape[0])
    if join_type in ("left_semi", "left_anti"):
        return _semi_anti(left, l_counts, join_type)
    if join_type == "inner":
        live = _live(pair_cap, n_pairs, left.device)
        lg = gather_rows(left, l_idx, n_pairs, out_capacity=pair_cap,
                         out_byte_caps=_string_byte_caps(left, l_idx, live)
                         or None)
        rg = gather_rows(right, r_idx, n_pairs, out_capacity=pair_cap,
                         out_byte_caps=_string_byte_caps(right, r_idx, live)
                         or None)
        return ColumnBatch(out_schema, list(lg.columns) + list(rg.columns),
                           n_pairs, pair_cap)
    if join_type in ("left", "right", "full"):
        unmatched = _unmatched(left, right, l_counts, r_matched, join_type)
        total_h = int(n_pairs + unmatched[2] + unmatched[3])
        out_cap = round_up_capacity(max(total_h, 1))
        li, l_valid, ri, r_valid, total = _outer_indices(
            left, right, l_idx, r_idx, n_pairs, unmatched, out_cap)
        # the caps count what the gather copies: NULL-padded rows gather
        # row 0's bytes (validity masked after), so the mask is `live`
        live = _live(out_cap, total, left.device)
        lg = gather_rows(left, li, total, out_capacity=out_cap,
                         out_byte_caps=_string_byte_caps(left, li, live)
                         or None)
        rg = gather_rows(right, ri, total, out_capacity=out_cap,
                         out_byte_caps=_string_byte_caps(right, ri, live)
                         or None)
        return ColumnBatch(out_schema, _padded(lg, l_valid) +
                           _padded(rg, r_valid), total, out_cap)
    raise ValueError(f"unsupported join type: {join_type}")


def stitch_join_output_static(left: ColumnBatch, right: ColumnBatch,
                              l_idx, r_idx, n_pairs, l_counts, r_matched,
                              join_type: str, out_schema: T.Schema,
                              growth: float):
    """:func:`stitch_join_output` at capacities chosen without a sync:
    semi/anti at the left capacity, inner at the pair capacity, outer at
    ``round_up_capacity(pair_cap + l_cap + r_cap)`` (all exact bounds);
    string byte capacities from :func:`_static_byte_caps`, checked on the
    device.  Returns ``(batch, overflow)``; on overflow the batch is
    invalid and the caller must rerun host-driven."""
    pair_cap = int(l_idx.shape[0])
    dev = left.device
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    if join_type in ("left_semi", "left_anti"):
        return _semi_anti(left, l_counts, join_type), no_ovf
    if join_type == "inner":
        live = _live(pair_cap, n_pairs, dev)
        lcaps = _static_byte_caps(left, growth, out_cap=pair_cap)
        rcaps = _static_byte_caps(right, growth, out_cap=pair_cap)
        ovf = _caps_overflow(_needed_bytes(left, l_idx, live), lcaps, dev) | \
            _caps_overflow(_needed_bytes(right, r_idx, live), rcaps, dev)
        lg = gather_rows(left, l_idx, n_pairs, out_capacity=pair_cap,
                         out_byte_caps=lcaps or None)
        rg = gather_rows(right, r_idx, n_pairs, out_capacity=pair_cap,
                         out_byte_caps=rcaps or None)
        return ColumnBatch(out_schema, list(lg.columns) + list(rg.columns),
                           n_pairs, pair_cap), ovf
    if join_type in ("left", "right", "full"):
        out_cap = round_up_capacity(pair_cap + left.capacity +
                                    right.capacity)
        li, l_valid, ri, r_valid, total = _outer_indices(
            left, right, l_idx, r_idx, n_pairs,
            _unmatched(left, right, l_counts, r_matched, join_type), out_cap)
        live = _live(out_cap, total, dev)
        # unmatched rows alone can fill a whole input: growth + 1
        lcaps = _static_byte_caps(left, growth + 1.0, out_cap=out_cap)
        rcaps = _static_byte_caps(right, growth + 1.0, out_cap=out_cap)
        ovf = _caps_overflow(_needed_bytes(left, li, live), lcaps, dev) | \
            _caps_overflow(_needed_bytes(right, ri, live), rcaps, dev)
        lg = gather_rows(left, li, total, out_capacity=out_cap,
                         out_byte_caps=lcaps or None)
        rg = gather_rows(right, ri, total, out_capacity=out_cap,
                         out_byte_caps=rcaps or None)
        return ColumnBatch(out_schema, _padded(lg, l_valid) +
                           _padded(rg, r_valid), total, out_cap), ovf
    raise ValueError(f"unsupported join type: {join_type}")


def hash_join(left: ColumnBatch, left_keys: List[DevVal],
              right: ColumnBatch, right_keys: List[DevVal],
              join_type: str, out_schema: T.Schema) -> ColumnBatch:
    """Equi-join of two batches, host-driven.  Output columns are the left
    columns then the right ones (semi/anti: the left only)."""
    l_idx, r_idx, n_pairs, l_counts, r_matched = join_pairs(
        left_keys, left.num_rows, right_keys, right.num_rows)
    return stitch_join_output(left, right, l_idx, r_idx, n_pairs, l_counts,
                              r_matched, join_type, out_schema)


def hash_join_static(left: ColumnBatch, left_keys: List[DevVal],
                     right: ColumnBatch, right_keys: List[DevVal],
                     join_type: str, out_schema: T.Schema,
                     growth: float = 2.0):
    """Equi-join with no host sync: the pair capacity is
    ``round_up_capacity(left.capacity * growth)``.  Returns ``(batch,
    overflow)``, ``overflow`` a 0-d bool on the device; on overflow the
    caller must discard the batch and rerun :func:`hash_join`."""
    pair_cap = round_up_capacity(max(int(left.capacity * growth), 1))
    l_idx, r_idx, n_pairs, l_counts, r_matched, ovf = join_pairs_static(
        left_keys, left.num_rows, right_keys, right.num_rows, pair_cap)
    out, ovf2 = stitch_join_output_static(
        left, right, l_idx, r_idx, n_pairs, l_counts, r_matched,
        join_type, out_schema, growth)
    return out, ovf | ovf2
