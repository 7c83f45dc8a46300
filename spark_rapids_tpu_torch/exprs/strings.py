"""String expressions on the device (port of the part of
``spark_rapids_tpu/exprs/strings.py`` the string path needs).

Device layout: int32 ``offsets[cap+1]`` into a flat uint8 byte buffer,
offsets constant past ``num_rows``, NULL rows of length 0.  The two kernels
of the path live in :mod:`spark_rapids_tpu_torch.kernels.cuda_tier` beside
their plain versions (which also hold the JAX package's primitives
``rows_of_positions``, ``_pow_table`` and ``_find_matches``, and the hash
bases ``HASH_BASES``):

* :func:`string_hash2`, the dual 32-bit polynomial row hashes that group,
  compare and tie-break strings (the ``stringHash`` kernel);
* :func:`_rows_with_match`, the contains scan behind ``contains`` and
  ``LIKE '%needle%'`` (the ``strings`` kernel).

``substring`` slices every row in one byte gather (:func:`_gather_substring`).

Patterns (needles) must be literals on the device; anything else runs on
the host twins (``cpu_eval``, the JAX package's: Python ``str`` tests, LIKE
as a regular expression, ``substring`` over characters where the device
counts bytes).  Dictionary-encoded columns are not ported: the port's
batches always hold materialized strings.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import (
    CpuVal, DevVal, Expression, Literal, UnaryExpression,
)
from spark_rapids_tpu_torch.kernels import cuda_tier


def string_lengths(v: DevVal) -> torch.Tensor:
    """int32[cap]: byte length of every row."""
    return (v.offsets[1:] - v.offsets[:-1]).to(torch.int32)


def string_hash2(v: DevVal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual 32-bit polynomial row hashes ``h = sum byte[i] *
    base^(end-1-i) + len * 0x9E3779B9 (mod 2^32)``, as int64 tensors
    holding u32 values.  Equality tests combine both hashes with the
    length (and the 64-byte sort prefix where exactness matters)."""
    return cuda_tier.string_hash_rows(v.data, v.offsets)


def hash_literal2(s: str) -> Tuple[int, int]:
    """:func:`string_hash2` of one literal string, on the host."""
    raw = s.encode("utf-8")
    out = []
    for base in cuda_tier.HASH_BASES:
        h = 0
        for b in raw:
            h = (h * base + b) % (1 << 32)
        h = (h + len(raw) * cuda_tier.HASH_GOLDEN) % (1 << 32)
        out.append(h)
    return out[0], out[1]


def _rows_with_match(v: DevVal, needle: bytes) -> torch.Tensor:
    """bool[cap]: the row holds ``needle`` (all rows for an empty one)."""
    return cuda_tier.rows_with_match(v.data, v.offsets, needle)


def _literal_needle(expr: Expression) -> Optional[str]:
    if isinstance(expr, Literal) and expr.value is not None:
        return str(expr.value)
    return None


def _match_prefix(v: DevVal, needle: bytes) -> torch.Tensor:
    cap = int(v.validity.shape[0])
    if len(needle) == 0:
        return torch.ones(cap, dtype=torch.bool, device=v.validity.device)
    nbytes = int(v.data.shape[0])
    ok = string_lengths(v) >= len(needle)
    starts = v.offsets[:-1].long()
    for k, b in enumerate(needle):
        idx = (starts + k).clamp(0, nbytes - 1)
        ok = ok & (v.data[idx] == b)
    return ok


def _match_suffix(v: DevVal, needle: bytes) -> torch.Tensor:
    cap = int(v.validity.shape[0])
    if len(needle) == 0:
        return torch.ones(cap, dtype=torch.bool, device=v.validity.device)
    nbytes = int(v.data.shape[0])
    ok = string_lengths(v) >= len(needle)
    ends = v.offsets[1:].long()
    for k, b in enumerate(needle):
        idx = (ends - len(needle) + k).clamp(0, nbytes - 1)
        ok = ok & (v.data[idx] == b)
    return ok


class _NeedlePredicate(Expression):
    """startswith/endswith/contains with a literal needle."""

    def __init__(self, child: Expression, needle: Expression):
        if not isinstance(needle, Expression):
            needle = Literal(str(needle), T.STRING)
        self.children = (child, needle)
        self.dtype = T.BOOLEAN
        self.nullable = child.nullable or needle.nullable

    def with_children(self, children):
        return type(self)(children[0], children[1])

    @property
    def needle(self) -> Optional[str]:
        return _literal_needle(self.children[1])

    def gpu_supported(self, conf):
        if not self.children[0].dtype.is_string:
            return f"{self.name}: the input is not a string"
        if self.needle is None:
            return f"{self.name}: the search pattern must be a literal"
        return None

    def _match_dev(self, v: DevVal, needle: bytes) -> torch.Tensor:
        raise NotImplementedError

    def _match_cpu(self, s: str, needle: str) -> bool:
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        data = self._match_dev(v, self.needle.encode("utf-8"))
        return DevVal(T.BOOLEAN, data, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        nv = self.children[1].cpu_eval(ctx)
        data = np.fromiter(
            (self._match_cpu(str(s), str(n))
             for s, n in zip(v.values, nv.values)),
            dtype=np.bool_, count=len(v.values))
        return CpuVal(T.BOOLEAN, data, v.validity & nv.validity)


class StringStartsWith(_NeedlePredicate):
    def _match_dev(self, v, needle):
        return _match_prefix(v, needle)

    def _match_cpu(self, s, needle):
        return s.startswith(needle)


class StringEndsWith(_NeedlePredicate):
    def _match_dev(self, v, needle):
        return _match_suffix(v, needle)

    def _match_cpu(self, s, needle):
        return s.endswith(needle)


class StringContains(_NeedlePredicate):
    def _match_dev(self, v, needle):
        return _rows_with_match(v, needle)

    def _match_cpu(self, s, needle):
        return needle in s


class Like(Expression):
    """SQL LIKE restricted to patterns that translate to exact, prefix,
    suffix, contains or prefix-and-suffix tests on the device: 'abc',
    'abc%', '%abc', '%abc%', 'a%b' (and '%').  Other patterns ('_'
    wildcards, escapes, several inner '%') run on the host twin, a regular
    expression ('%' any run, '_' any one character)."""

    def __init__(self, child: Expression, pattern: str):
        self.children = (child,)
        self.pattern = pattern
        self.dtype = T.BOOLEAN
        self.nullable = child.nullable

    def with_children(self, children):
        return Like(children[0], self.pattern)

    def __repr__(self):
        return f"{self.children[0]!r} LIKE {self.pattern!r}"

    def _plan(self):
        p = self.pattern
        if "_" in p or "\\" in p:
            return None
        parts = p.split("%")
        if len(parts) == 1:
            return ("exact", parts[0])
        if len(parts) == 2:
            if parts[0] == "" and parts[1] == "":
                return ("any",)
            if parts[1] == "":
                return ("prefix", parts[0])
            if parts[0] == "":
                return ("suffix", parts[1])
            return ("prefix_suffix", parts[0], parts[1])
        if len(parts) == 3 and parts[0] == "" and parts[2] == "":
            return ("contains", parts[1])
        return None

    def gpu_supported(self, conf):
        if not self.children[0].dtype.is_string:
            return "Like: the input is not a string"
        if self._plan() is None:
            return f"Like: pattern {self.pattern!r} is not ported"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        plan = self._plan()
        kind = plan[0]
        v = self.children[0].gpu_eval(ctx)
        cap = int(v.validity.shape[0])
        if kind == "any":
            data = torch.ones(cap, dtype=torch.bool, device=v.validity.device)
        elif kind == "exact":
            h1, h2 = string_hash2(v)
            e1, e2 = hash_literal2(plan[1])
            data = (h1 == e1) & (h2 == e2)
        elif kind == "prefix":
            data = _match_prefix(v, plan[1].encode())
        elif kind == "suffix":
            data = _match_suffix(v, plan[1].encode())
        elif kind == "contains":
            data = _rows_with_match(v, plan[1].encode())
        else:  # prefix_suffix
            pre, suf = plan[1], plan[2]
            data = (_match_prefix(v, pre.encode())
                    & _match_suffix(v, suf.encode())
                    & (string_lengths(v) >= len(pre) + len(suf)))
        return DevVal(T.BOOLEAN, data, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        regex = "^" + "".join(
            ".*" if c == "%" else "." if c == "_" else re.escape(c)
            for c in self.pattern) + "$"
        rx = re.compile(regex, re.DOTALL)
        data = np.fromiter((rx.match(str(s)) is not None for s in v.values),
                           dtype=np.bool_, count=len(v.values))
        return CpuVal(T.BOOLEAN, data, v.validity)


# ---------------------------------------------------------------------------
# substring
# ---------------------------------------------------------------------------


def _substr_bounds(length: torch.Tensor, pos: int, sublen: Optional[int]):
    """(start, n) int32 of Spark's substring (``UTF8String.substringSQL``)
    over row lengths: 1-based ``pos``, counted from the end when
    negative; the length window is measured from the raw (possibly
    negative) start before either end is clamped into the row."""
    length = length.to(torch.int64)
    if pos > 0:
        start_raw = torch.full_like(length, pos - 1)
    elif pos == 0:
        start_raw = torch.zeros_like(length)
    else:
        start_raw = length + pos
    end_raw = length if sublen is None else start_raw + max(sublen, 0)
    start = torch.minimum(start_raw.clamp(min=0), length)
    end = torch.minimum(end_raw.clamp(min=0), length)
    n = (end - start).clamp(min=0)
    return start.to(torch.int32), n.to(torch.int32)


def _gather_substring(v: DevVal, starts: torch.Tensor, new_lens: torch.Tensor,
                      out_byte_cap: int, validity: torch.Tensor) -> DevVal:
    """A string column whose row r is bytes ``[starts[r], starts[r] +
    new_lens[r])`` of input row r: offsets from one cumsum of the new
    lengths, then one gather, each output byte finding its row with a
    ``searchsorted``.  Bytes past the new total are 0."""
    dev = v.data.device
    cap = int(new_lens.shape[0])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(new_lens, 0, dtype=torch.int32)])
    pos = torch.arange(out_byte_cap, dtype=torch.int32, device=dev)
    rows = cuda_tier.rows_of_positions(offsets, out_byte_cap)
    rows_c = rows.clamp(0, cap - 1).long()
    src = v.offsets[:-1][rows_c] + starts[rows_c] + pos - offsets[rows_c]
    src = src.clamp(0, int(v.data.shape[0]) - 1).long()
    data = torch.where(pos < offsets[-1], v.data[src], 0).to(torch.uint8)
    return DevVal(T.STRING, data, validity, offsets)


class Substring(UnaryExpression):
    """``substring(str, pos[, len])`` over UTF-8 bytes, as the JAX
    package's device path counts them (Spark counts characters: the two
    agree on ASCII).  NULL rows and rows past ``num_rows`` come out
    empty; the output keeps the input's byte capacity.  The host twin
    counts characters, as the JAX package's does."""

    def __init__(self, child: Expression, pos: int,
                 length: Optional[int] = None):
        self.pos = int(pos)
        self.sublen = None if length is None else int(length)
        super().__init__(child)

    def with_children(self, children):
        return Substring(children[0], self.pos, self.sublen)

    def _resolve_type(self):
        self.dtype = T.STRING
        self.nullable = self.child.nullable

    def gpu_supported(self, conf):
        if not self.child.dtype.is_string:
            return "Substring: the input is not a string"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        start, n = _substr_bounds(string_lengths(v), self.pos, self.sublen)
        cap = int(v.validity.shape[0])
        live = torch.arange(cap, dtype=torch.int32,
                            device=v.validity.device) < ctx.batch.num_rows
        n = torch.where(v.validity & live, n, 0)
        return _gather_substring(v, start, n, int(v.data.shape[0]),
                                 v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        out = np.empty(len(v.values), dtype=object)
        for i, s in enumerate(v.values):
            s = str(s)
            n = len(s)
            if self.pos > 0:
                start_raw = self.pos - 1
            elif self.pos == 0:
                start_raw = 0
            else:
                start_raw = n + self.pos
            end_raw = n if self.sublen is None else \
                start_raw + max(self.sublen, 0)
            out[i] = s[min(max(start_raw, 0), n):min(max(end_raw, 0), n)]
        return CpuVal(T.STRING, out, v.validity)
