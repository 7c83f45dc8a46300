"""Slot aggregation: a groupby that scatters straight into a key-indexed
table (port of ``spark_rapids_tpu/kernels/hashagg.py``).

Each group key column contributes a mixed-radix digit (its offset from the
batch minimum, plus a NULL digit when the column has NULLs); the digits pack
into ONE slot index, a bijection onto ``[0, prod(radix))``, so there is no
hash and no collision.  A batch whose packed key space exceeds the table
(or whose float sum sees NaN/Inf) raises a device-side flag and the caller
re-runs the exact sort path.

The JAX package reduces with a one-hot einsum on the TPU's matrix unit.
Here the same stacked rows go through one ``index_add_`` keyed by
``(chunk, slot)``.  The rows are unchanged: integer values as 8-bit limb
rows, floats as 53-bit fixed-point limb rows against a per-chunk scale, all
integer-valued f32 whose per-chunk sums stay below 2^24 — exact in any
summation order, so atomics on the card give the reference's sums bit for
bit.  min/max, first/last and the central moments ride the same slot ids
through the aggregates' own segment kernels (the JAX package sends the
moments to its sort path; the slot ids give the same groups).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (
    ColumnBatch, DeviceColumn, round_up_capacity,
)
from spark_rapids_tpu_torch.exprs.base import DevVal
from spark_rapids_tpu_torch.kernels.layout import compaction_indices

TABLE_SLOTS = 8192          # key-range capacity of the slot table
_CHUNK = 16384              # rows per exact-f32 accumulation chunk
_DEAD_SLOTS = 1024          # scratch slots the dead rows are spread over
_M32 = 0xFFFFFFFF
_SIGN32 = 1 << 31
_FIX_BITS = 53              # fixed-point precision of the float limb rows
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def _limb_rows_u32(w: torch.Tensor, use: torch.Tensor
                   ) -> List[torch.Tensor]:
    """f32 rows of the four 8-bit limbs of a u32 word (held in int64),
    zeroed where !use."""
    return [((w >> (8 * j)) & 0xFF).to(torch.float32).masked_fill(~use, 0.0)
            for j in range(4)]


def _int_value_words(x: torch.Tensor, use: torch.Tensor
                     ) -> List[Tuple[torch.Tensor, bool]]:
    """(u32 word, biased) pairs whose limb sums recombine to sum(x) in
    int64.  The hi word is sign-biased by 2^31 so limbs stay unsigned."""
    x = x.to(torch.int64)
    lo = (x & _M32).masked_fill(~use, 0)
    hi = (((x >> 32) & _M32) ^ _SIGN32).masked_fill(~use, 0)
    return [(lo, False), (hi, True)]


def _float_limb_rows(x: torch.Tensor, use: torch.Tensor, nc: int, c: int):
    """(7 f32 limb rows, per-chunk f64 scales) for exact-ish float sums.

    Per chunk: scale = max|x|; q = (x/scale + 1) * 2^53 as int64; 8-bit
    limbs of q.  Recombination is exact integer math until one final f64
    rounding — per-row truncation error <= scale * 2^-53."""
    x = x.to(torch.float64)
    ax = x.masked_fill(~use, 0.0).abs().reshape(nc, c)
    cmax = ax.amax(dim=1)
    scale = torch.where(cmax > 0, cmax, 1.0)
    y = x.reshape(nc, c) / scale[:, None]
    z = torch.where(use.reshape(nc, c), y + 1.0, 0.0)
    qi = (z * float(2 ** _FIX_BITS)).to(torch.int64)
    rows = [((qi >> (8 * (6 - j))) & 0xFF).to(torch.float32).reshape(nc * c)
            for j in range(7)]
    return rows, scale


def hash_group_aggregate(batch: ColumnBatch, key_vals: List[DevVal],
                         agg_inputs: List[DevVal], agg_fns: Sequence,
                         key_schema: T.Schema, table: int = TABLE_SLOTS,
                         row_base: int = 0):
    """(group-key batch, per-agg buffer lists, n_groups, fallback flag).

    Buffer layout matches the sort-based update path.  ``fallback`` (a 0-d
    bool device tensor) True means the key range did not fit the slot
    table or a float sum saw non-finite values: the caller MUST discard the
    result and use the sort path.  ``row_base`` is added to each row's
    position for the aggregates that pick by input index (first, last)."""
    from spark_rapids_tpu_torch.exprs.aggregates import (
        Count, Max, Min, Sum, _CentralMoment, _FirstLast,
    )

    cap = batch.capacity
    dev = batch.device
    c = min(_CHUNK, cap)
    nc = cap // c
    live = torch.arange(cap, dtype=torch.int32, device=dev) < batch.num_rows

    # ---- mixed-radix slot packing over all key columns -------------------
    fallback = torch.zeros((), dtype=torch.bool, device=dev)
    slot64 = torch.zeros(cap, dtype=torch.int64, device=dev)
    stride = torch.ones((), dtype=torch.int64, device=dev)
    prod_f = torch.ones((), dtype=torch.float64, device=dev)
    zero64 = torch.zeros((), dtype=torch.int64, device=dev)
    key_decode = []  # (kmin, rng, radix, stride) per key, for output
    for kv in key_vals:
        kx = kv.data.to(torch.int64)
        usek = live & kv.validity
        any_key = usek.any()
        has_null = (live & ~kv.validity).any()
        kmin = kx.masked_fill(~usek, _I64_MAX).amin()
        kmax = kx.masked_fill(~usek, _I64_MIN).amax()
        # wrap-around of (kmax - kmin) goes negative -> correctly rejected
        key_fits = (kmax - kmin >= 0) & (kmax - kmin < table + 1)
        fallback = fallback | (any_key & ~key_fits)
        ok = any_key & key_fits
        kmin = torch.where(ok, kmin, zero64)
        rng = torch.where(ok, kmax - kmin + 1, zero64)
        radix = torch.clamp(rng + has_null.to(torch.int64), min=1)
        digit = torch.where(usek, (kx - kmin).clamp(0, table), rng)
        slot64 = slot64 + digit * stride
        key_decode.append((kmin, rng, radix, stride))
        stride = stride * radix
        prod_f = prod_f * radix.to(torch.float64)
    # capacity check in f64: an int64 stride product can wrap silently
    fallback = fallback | (prod_f > float(table + 1))

    # slots: 0..table = packed key tuples, then _DEAD_SLOTS scratch slots
    # for the dead rows (the JAX package uses the single slot table+1).
    # Past a filter most of a batch is dead; spread over many slots their
    # scatters do not all contend for one address.  Scratch slots are cut.
    tt = table + 1 + _DEAD_SLOTS
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    slot = torch.where(live, slot64.clamp(0, table),
                       table + 1 + iota % _DEAD_SLOTS)

    # ---- stacked limb rows -----------------------------------------------
    rows: List[torch.Tensor] = [live.to(torch.float32)]  # per-slot count
    agg_plan = []
    for fn, v in zip(agg_fns, agg_inputs):
        if type(fn) in (Min, Max) or \
                isinstance(fn, (_CentralMoment, _FirstLast)):
            agg_plan.append(("segment", fn, v))
            continue
        use = v.validity & live
        use_at = len(rows)
        rows.append(use.to(torch.float32))                # per-agg count
        if type(fn) is Count:
            agg_plan.append(("count", use_at))
            continue
        if v.dtype.is_integral or v.dtype == T.BOOLEAN:
            spec = []
            for w, biased in _int_value_words(v.data, use):
                spec.append((len(rows), biased))
                rows.extend(_limb_rows_u32(w, use))
            agg_plan.append(("int_sum", use_at, spec, type(fn)))
        else:
            # fixed-point rows need finite, sanely-scaled values; others
            # take the sort path, which keeps float semantics
            x64 = v.data.to(torch.float64)
            fallback = fallback | (use & (~torch.isfinite(x64) |
                                          (x64.abs() > 2.0 ** 1000))).any()
            at = len(rows)
            fr, scale = _float_limb_rows(v.data, use, nc, c)
            rows.extend(fr)
            agg_plan.append(("float_sum", use_at, at, scale, type(fn)))

    # per (chunk, slot) sums of every row: ONE index_add_ of [R, cap]
    r_n = len(rows)
    stacked = torch.stack(rows)                           # [R, cap] f32
    target = torch.zeros(r_n, nc * tt, dtype=torch.float32, device=dev)
    target.index_add_(1, (iota // c) * tt + slot, stacked)
    per_chunk = target.reshape(r_n, nc, tt).permute(1, 0, 2)  # [nc, R, tt]
    totals_i = per_chunk.to(torch.int64).sum(dim=0)       # [R, tt]

    used = totals_i[0][:table + 1] > 0                    # incl NULL group

    # ---- buffers ----------------------------------------------------------
    def _int_total(spec, use_at):
        total = torch.zeros(tt, dtype=torch.int64, device=dev)
        for base_at, biased in spec:
            word_sum = torch.zeros(tt, dtype=torch.int64, device=dev)
            for k in range(4):
                word_sum = word_sum + (totals_i[base_at + k] << (8 * k))
            if biased:
                word_sum = (word_sum - (totals_i[use_at] << 31)) << 32
            total = total + word_sum
        return total

    ng = table + 1
    ones_t = torch.ones(ng, dtype=torch.bool, device=dev)
    buffer_cols: List[List[DevVal]] = []
    for plan, fn in zip(agg_plan, agg_fns):
        kind = plan[0]
        if kind == "segment":
            _, sfn, sv = plan
            if getattr(sfn, "takes_row_index", False):
                sb = sfn.segment_update(sv, slot, tt, live,
                                        row_index=iota + row_base)
            else:
                sb = sfn.segment_update(sv, slot, tt, live)
            bufs = [DevVal(b.dtype, b.data[:ng], b.validity[:ng])
                    for b in sb]
        elif kind == "count":
            bufs = [DevVal(T.LONG, totals_i[plan[1]][:ng], ones_t)]
        elif kind == "int_sum":
            _, use_at, spec, fcls = plan
            total = _int_total(spec, use_at)[:ng]
            cnt = totals_i[use_at][:ng]
            if fcls is Sum:
                bufs = [DevVal(fn.dtype, total.to(fn.dtype.torch_dtype),
                               ones_t),
                        DevVal(T.BOOLEAN, cnt > 0, ones_t)]
            else:  # Average over ints: exact f64 sum from the i64 total
                bufs = [DevVal(T.DOUBLE, total.to(torch.float64), ones_t),
                        DevVal(T.LONG, cnt, ones_t)]
        else:  # float_sum
            _, use_at, base_at, scale, fcls = plan
            z = torch.zeros(nc, tt, dtype=torch.float64, device=dev)
            for j in range(7):
                z = z + per_chunk[:, base_at + j, :].to(torch.float64) \
                    * float(2 ** (8 * (6 - j)))
            cnt_pc = per_chunk[:, use_at, :].to(torch.float64)
            y = z / float(2 ** _FIX_BITS) - cnt_pc
            total = (y * scale[:, None]).sum(dim=0)[:ng]
            cnt = totals_i[use_at][:ng]
            if fcls is Sum:
                bufs = [DevVal(T.DOUBLE, total, ones_t),
                        DevVal(T.BOOLEAN, cnt > 0, ones_t)]
            else:
                bufs = [DevVal(T.DOUBLE, total, ones_t),
                        DevVal(T.LONG, cnt, ones_t)]
        buffer_cols.append(bufs)

    # ---- compact used slots; keys decoded from slot indices --------------
    # digit_i = (slot // stride_i) % radix_i; the NULL digit rng_i decodes
    # to validity False
    idx, n_groups = compaction_indices(used, ng)
    out_cap = round_up_capacity(ng)
    idx_p = torch.zeros(out_cap, dtype=torch.int64, device=dev)
    idx_p[:ng] = idx
    live_out = torch.arange(out_cap, dtype=torch.int32,
                            device=dev) < n_groups
    key_cols = []
    for kf, (kmin, rng, radix, kstride) in zip(key_schema.fields,
                                               key_decode):
        d = torch.div(idx_p, kstride, rounding_mode="floor") % radix
        key_data = (kmin + d).to(kf.dtype.torch_dtype)
        key_cols.append(DeviceColumn(kf.dtype, key_data,
                                     (d < rng) & live_out))
    group_keys = ColumnBatch(key_schema, key_cols, n_groups, out_cap)

    def _pad(a):
        out = torch.zeros(out_cap, dtype=a.dtype, device=dev)
        out[:ng] = a[idx_p[:ng]]
        return out

    compact_bufs = [[DevVal(b.dtype, _pad(b.data), _pad(b.validity))
                     for b in bufs] for bufs in buffer_cols]
    return group_keys, compact_bufs, n_groups, fallback


def hash_agg_capable(mode: str, key_types: List[T.DataType],
                     agg_fns: Sequence) -> bool:
    """Static capability check: sum/count/avg/min/max, first/last and
    the central moments over fixed-width inputs, grouped by
    integral/date/bool keys."""
    from spark_rapids_tpu_torch.exprs.aggregates import (
        Average, Count, Max, Min, Sum, _CentralMoment, _FirstLast,
    )
    if mode != "update":
        return False
    for kt in key_types:
        if not (kt.is_integral or kt in (T.DATE, T.BOOLEAN)):
            return False
    for fn in agg_fns:
        if type(fn) in (Sum, Average, Min, Max) or \
                isinstance(fn, (_CentralMoment, _FirstLast)):
            if fn.child.dtype.is_string:
                return False
        elif type(fn) is not Count:
            return False
    return True
