"""Order-preserving sort-key words (port of
``spark_rapids_tpu/kernels/sortkeys.py``).

Every key column is encoded into 32-bit words whose lexicographic order is
the SQL order (ascending/descending, nulls first/last, padding rows last),
exactly the JAX package's uint32 words.  ``torch.uint32`` lacks sorts,
shifts and comparisons on CUDA, so each word lives in an int64 tensor
holding the u32 value (always in ``[0, 2^32)``).

Encodings: int8/16/32/date one word (value ^ sign bit); int64/timestamp two
words (biased hi, raw lo); float/double with NaN canonicalized (sorts
greatest) and -0.0 == 0.0, then the IEEE flip (negative: all bits flipped,
else sign bit set); boolean 0/1; string: the first
``DEFAULT_STRING_PREFIX_BYTES`` bytes packed big-endian four to a word
(zero-padded, so a shorter prefix sorts first, Spark's unsigned byte
order), then (length, h1, h2) so that fully equal strings always land next
to each other even past the prefix.  A grouping-only string key (the
caller needs equal keys adjacent, not an order between distinct keys)
encodes as (length, h1, h2) alone.  Order between distinct strings that
share the 64-byte prefix is approximate, as in the JAX package.

The string keys' hashes come from one stringHash launch for all of them
(:func:`string_key_hashes`); a caller that has them already (the group
sort, for its adjacent-key test) hands them in instead of hashing again.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import DevVal
from spark_rapids_tpu_torch.kernels import cuda_tier

_M32 = 0xFFFFFFFF
_SIGN32 = 1 << 31
DEFAULT_STRING_PREFIX_BYTES = 64


def _flip_float_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 IEEE order word from u32 float bits (held in int64)."""
    neg = (bits & _SIGN32) != 0
    return torch.where(neg, ~bits & _M32, bits | _SIGN32)


def _encode_fixed_words(v: DevVal) -> List[torch.Tensor]:
    """Order-preserving u32 words (int64 tensors) of a fixed-width column."""
    dt = v.dtype
    if dt == T.BOOLEAN:
        return [v.data.to(torch.int64)]
    if dt in (T.BYTE, T.SHORT, T.INT, T.DATE):
        return [(v.data.to(torch.int64) & _M32) ^ _SIGN32]
    if dt in (T.LONG, T.TIMESTAMP):
        x = v.data.to(torch.int64)
        return [((x >> 32) & _M32) ^ _SIGN32, x & _M32]
    if dt == T.FLOAT:
        x = v.data.to(torch.float32)
        x = torch.where(torch.isnan(x), float("nan"), x)
        x = torch.where(x == 0.0, 0.0, x)
        return [_flip_float_bits(x.view(torch.int32).to(torch.int64) & _M32)]
    if dt == T.DOUBLE:
        x = v.data.to(torch.float64)
        x = torch.where(torch.isnan(x), float("nan"), x)
        x = torch.where(x == 0.0, 0.0, x)
        bits = x.view(torch.int64)
        hi = (bits >> 32) & _M32
        lo = bits & _M32
        neg = (hi & _SIGN32) != 0
        return [torch.where(neg, ~hi & _M32, hi | _SIGN32),
                torch.where(neg, ~lo & _M32, lo)]
    raise NotImplementedError(f"sort keys of type {dt} are not ported yet")


def string_prefix_words(v: DevVal, prefix_bytes: int
                        ) -> List[torch.Tensor]:
    """u32 words (int64) of each row's first ``prefix_bytes`` bytes,
    packed big-endian four to a word, 0 past the row's end.  One gather of
    a ``[cap, 4]`` byte block per word."""
    offsets, data = v.offsets, v.data
    nbytes = int(data.shape[0])
    lens = (offsets[1:] - offsets[:-1]).long()
    starts = offsets[:-1].long()
    lane = torch.arange(4, dtype=torch.int64, device=data.device)
    shifts = 24 - 8 * lane
    words: List[torch.Tensor] = []
    for w in range((prefix_bytes + 3) // 4):
        j = 4 * w + lane
        src = (starts[:, None] + j).clamp(0, nbytes - 1)
        byte = torch.where(j < lens[:, None], data[src].long(), 0)
        words.append((byte << shifts).sum(dim=1))
    return words


def string_key_hashes(vals: List[DevVal]) -> List[Optional[tuple]]:
    """(h1, h2) of every string value of ``vals`` (``string_hash2``'s
    words), None for the others: one stringHash launch for all of them."""
    hashes = iter(cuda_tier.string_hash_columns(
        [(v.data, v.offsets) for v in vals if v.dtype.is_string]))
    return [next(hashes) if v.dtype.is_string else None for v in vals]


def _string_tail_words(v: DevVal, hashes: tuple) -> List[torch.Tensor]:
    """(length, h1, h2) u32 words: equal strings share all three."""
    lens = (v.offsets[1:] - v.offsets[:-1]).to(torch.int64) & _M32
    return [lens, *hashes]


def encode_sort_keys(vals: List[DevVal], ascendings: List[bool],
                     nulls_firsts: List[bool], num_rows,
                     groupings: Optional[List[bool]] = None,
                     liveness: bool = True,
                     hashes: Optional[List[Optional[tuple]]] = None
                     ) -> List[torch.Tensor]:
    """Full u32 key-word list for a multi-column sort.

    With ``liveness`` a leading word sends padding rows (row >= num_rows)
    to the end; it is folded into the first key's null-rank word (both are
    un-negated 1-bit ranks).  Each key contributes a null-rank word then
    its value words; NULL values all encode as 0 so NULLs compare equal.
    ``groupings[i]`` marks key i grouping-only: a string key then encodes
    as (length, h1, h2) alone instead of prefix words + those three.
    ``hashes`` are the string keys' hashes as :func:`string_key_hashes`
    gives them (computed here when None)."""
    cap = int(vals[0].validity.shape[0]) if vals else 0
    if hashes is None:
        hashes = string_key_hashes(vals)
    words: List[torch.Tensor] = []
    if liveness:
        dev = vals[0].validity.device
        live = torch.arange(cap, dtype=torch.int32, device=dev) < num_rows
        words.append((~live).to(torch.int64))
    if groupings is None:
        groupings = [False] * len(vals)
    for v, asc, nf, grp, h in zip(vals, ascendings, nulls_firsts, groupings,
                                  hashes):
        null_rank = v.validity if nf else ~v.validity
        words.append(null_rank.to(torch.int64))
        if v.dtype.is_string:
            vwords = _string_tail_words(v, h)
            if not grp:
                vwords = string_prefix_words(
                    v, DEFAULT_STRING_PREFIX_BYTES) + vwords
        else:
            vwords = _encode_fixed_words(v)
        for w in vwords:
            w = w.masked_fill(~v.validity, 0)
            words.append(w if asc else ~w & _M32)
    if liveness and len(words) >= 2:
        words = [(words[0] << 1) | words[1]] + words[2:]
    return words


def argsort_by_words(words: List[torch.Tensor], cap: int) -> torch.Tensor:
    """Stable permutation (int64[cap]) ordering rows by the word tuple —
    the permutation ``jax.lax.sort(..., is_stable=True)`` gives.

    Words are packed pairwise into one int64 key, ``(hi - 2^31) * 2^32 +
    lo``, which orders as the (hi, lo) pair does; then a least-significant-
    key-first chain of stable sorts, each pass keeping the order of the
    passes before it."""
    if not words:
        raise ValueError("argsort_by_words needs at least one word")
    keys = [words[0]] if len(words) % 2 else []
    for i in range(len(words) % 2, len(words), 2):
        keys.append((words[i] - _SIGN32) * (1 << 32) + words[i + 1])
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        _, order = torch.sort(k, stable=True)
        perm = order if perm is None else perm[order]
    return perm


def keys_equal_prev(vals: List[DevVal],
                    hashes: List[Optional[tuple]]) -> torch.Tensor:
    """bool[cap]: row i's key tuple exactly equals row i-1's (False at 0).
    Strings compare by (length, h1, h2, 64-byte prefix words): unequal
    strings that agree on all of them would need an engineered collision
    of both 32-bit hashes.  ``hashes`` are the rows' string key hashes as
    :func:`string_key_hashes` gives them."""
    cap = int(vals[0].validity.shape[0])
    eq = torch.ones(cap, dtype=torch.bool, device=vals[0].validity.device)

    def shift_ne(x):
        return x != torch.cat([x[:1], x[:-1]])

    for v, h in zip(vals, hashes):
        eq = eq & ~shift_ne(v.validity)
        if v.dtype.is_string:
            cmp_words = _string_tail_words(v, h) + string_prefix_words(
                v, DEFAULT_STRING_PREFIX_BYTES)
        else:
            cmp_words = _encode_fixed_words(v)
        for w in cmp_words:
            eq = eq & (~shift_ne(w) | ~v.validity)
    eq[0] = False
    return eq
