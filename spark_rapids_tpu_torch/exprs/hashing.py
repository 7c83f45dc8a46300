"""Murmur3 hash expression (port of ``spark_rapids_tpu/exprs/hashing.py``):
Spark's murmur3_x86_32 with seed 42, bit for bit the JAX package's.

The JAX package computes in uint32.  Torch has no general uint32
arithmetic on CUDA, so the device form holds each u32 in an int64 and masks
it to 32 bits after every multiply and rotate; a multiply takes the u32
operand in 16-bit halves, so no product leaves int64's range (signed
overflow is never relied on).  The host twin computes in numpy uint32,
as the JAX package's does.

Each column is hashed as 32-bit words, the running hash its seed, and a
NULL leaves the hash unchanged: BOOLEAN, BYTE, SHORT, INT and DATE as one
int word; LONG and TIMESTAMP as (low, high); FLOAT as its bits with -0.0
taken as 0.0; DOUBLE as the JAX package's two-float encoding (the f32
``hi`` and ``lo = x - hi`` in f32, ``lo`` 0 where ``hi`` is not finite,
NaN canonical, -0.0 as 0.0, low word ``lo`` first), not its raw IEEE bits;
STRING as the two polynomial row hashes of ``exprs/strings.py``
(``string_hash2``: the stringHash kernel on a CUDA tensor).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import CpuVal, DevVal, Expression

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF
_INT_WORD = (T.BOOLEAN, T.BYTE, T.SHORT, T.INT, T.DATE)
_LONG_WORDS = (T.LONG, T.TIMESTAMP)


def hashable(dtype: T.DataType) -> bool:
    return dtype in _INT_WORD + _LONG_WORDS + (T.FLOAT, T.DOUBLE) or \
        dtype.is_string


# ---- device: u32 values held in int64 --------------------------------------


def _mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for a u32 ``a`` held in int64."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul(_rotl(_mul(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (_mul(h1, 5) + 0xE6546B64) & _M32


def _fmix(h: torch.Tensor, length: int) -> torch.Tensor:
    h = h ^ length
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _f32_bits(f: torch.Tensor) -> torch.Tensor:
    return f.contiguous().view(torch.int32).to(torch.int64) & _M32


def _canonical_f32(f: torch.Tensor) -> torch.Tensor:
    f = torch.where(torch.isnan(f), float("nan"), f)
    return torch.where(f == 0, 0.0, f)


def _words(v: DevVal):
    """(u32 words as int64 tensors, byte length) of one column."""
    dt, data = v.dtype, v.data
    if dt in _INT_WORD:
        return [data.to(torch.int32).to(torch.int64) & _M32], 4
    if dt in _LONG_WORDS:
        x = data.to(torch.int64)
        return [x & _M32, (x >> 32) & _M32], 8
    if dt == T.FLOAT:
        x = torch.where(data == 0, 0.0, data).to(torch.float32)
        return [_f32_bits(x)], 4
    if dt == T.DOUBLE:
        x = torch.where(data == 0, 0.0, data.to(torch.float64))
        hi = x.to(torch.float32)  # round to nearest even; past f32: inf
        lo = (x - hi.to(torch.float64)).to(torch.float32)
        lo = torch.where(torch.isfinite(hi), lo, 0.0)
        return [_f32_bits(_canonical_f32(lo)),
                _f32_bits(_canonical_f32(hi))], 8
    if dt.is_string:
        from spark_rapids_tpu_torch.exprs.strings import string_hash2
        h1, h2 = string_hash2(v)
        return [h1, h2], 8
    raise TypeError(f"murmur3 of {dt}")


def murmur3_cols(vals: Sequence[DevVal], seed: int = 42) -> torch.Tensor:
    """int32 row hash over several device columns, each column's hash the
    next one's seed; a NULL leaves the running hash unchanged."""
    cap = int(vals[0].validity.shape[0])
    h = torch.full((cap,), seed & _M32, dtype=torch.int64,
                   device=vals[0].validity.device)
    for v in vals:
        words, length = _words(v)
        hv = h
        for w in words:
            hv = _mix_h1(hv, _mix_k1(w))
        h = torch.where(v.validity, _fmix(hv, length), h)
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


# ---- host twin: numpy uint32 -----------------------------------------------


def _rotl_np(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mix_k1_np(k1):
    k1 = k1 * np.uint32(_C1)
    return _rotl_np(k1, 15) * np.uint32(_C2)


def _mix_h1_np(h1, k1):
    h1 = _rotl_np(h1 ^ k1, 13)
    return h1 * np.uint32(5) + np.uint32(0xE6546B64)


def _fmix_np(h, length):
    h = h ^ np.uint32(length)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _canonical_f32_np(f):
    f = np.where(np.isnan(f), np.float32(np.nan), f)
    return np.where(f == 0, np.float32(0.0), f).astype(np.float32)


def _words_np(v: CpuVal):
    dt, data = v.dtype, np.asarray(v.values)
    if dt in _INT_WORD:
        return [data.astype(np.int32).view(np.uint32)], 4
    if dt in _LONG_WORDS:
        x = data.astype(np.int64).view(np.uint64)
        return [(x & np.uint64(_M32)).astype(np.uint32),
                (x >> np.uint64(32)).astype(np.uint32)], 8
    if dt == T.FLOAT:
        x = np.where(data == 0, np.float32(0.0), data).astype(np.float32)
        return [x.view(np.uint32)], 4
    if dt == T.DOUBLE:
        x = np.where(data == 0, 0.0, data).astype(np.float64)
        with np.errstate(invalid="ignore", over="ignore"):
            hi = x.astype(np.float32)
            lo = (x - hi.astype(np.float64)).astype(np.float32)
        lo = np.where(np.isfinite(hi), lo, np.float32(0.0))
        return [_canonical_f32_np(lo).view(np.uint32),
                _canonical_f32_np(hi).view(np.uint32)], 8
    if dt.is_string:
        from spark_rapids_tpu_torch.batch import _string_host_to_buffers
        from spark_rapids_tpu_torch.kernels import cuda_tier
        offsets, raw = _string_host_to_buffers(data, v.validity)
        h1, h2 = cuda_tier.string_hash_rows_reference(
            torch.from_numpy(raw), torch.from_numpy(offsets))
        return [h1.numpy().astype(np.uint32),
                h2.numpy().astype(np.uint32)], 8
    raise TypeError(f"murmur3 of {dt}")


def murmur3_cols_cpu(vals: Sequence[CpuVal], seed: int = 42) -> np.ndarray:
    n = len(vals[0].validity)
    h = np.full(n, np.uint32(seed & _M32), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for v in vals:
            words, length = _words_np(v)
            hv = h
            for w in words:
                hv = _mix_h1_np(hv, _mix_k1_np(w))
            h = np.where(v.validity, _fmix_np(hv, length), h)
    return h.astype(np.uint32).view(np.int32)


class Murmur3Hash(Expression):
    """hash(c1, c2, ...): INT, never NULL."""

    def __init__(self, *children: Expression, seed: int = 42):
        self.children = tuple(children)
        self.seed = seed
        self.dtype = T.INT
        self.nullable = False

    def with_children(self, children):
        return Murmur3Hash(*children, seed=self.seed)

    def gpu_supported(self, conf):
        bad = [c.dtype for c in self.children if not hashable(c.dtype)]
        if bad:
            return f"Murmur3Hash: no hash of {bad[0]} is ported"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        data = murmur3_cols([c.gpu_eval(ctx) for c in self.children],
                            self.seed)
        return DevVal(T.INT, data, torch.ones_like(data, dtype=torch.bool))

    def cpu_eval(self, ctx) -> CpuVal:
        data = murmur3_cols_cpu([c.cpu_eval(ctx) for c in self.children],
                                self.seed)
        return CpuVal(T.INT, data, np.ones(len(data), dtype=np.bool_))

