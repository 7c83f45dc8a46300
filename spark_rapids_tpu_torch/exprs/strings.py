"""String expressions (port of ``spark_rapids_tpu/exprs/strings.py``).

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

Every function that makes a string builds it with :func:`build_string`
(the JAX package's): per-row output lengths, offsets from one cumsum, and
one pass over the output bytes, each finding its row with
``rows_of_positions``.  The output's byte capacity is the JAX package's
static one (the input's for a slice, the two inputs' sum for a concat,
``cap * len`` for a pad, ``cap * 16`` for ``hex``, the fixed width times
``cap`` for a formatted date), so a build reads nothing back to the host;
it is checked against int32 offsets, and bytes past the live total are 0.
Where a function needs a row's k-th match or kept byte (trims, locate,
split_part, substring_index, replace), :class:`_RowFlags` finds it by one
prefix count and a ``searchsorted`` where the JAX package takes segment
reductions; the bits are the same.  Case mapping is ASCII only, as in the
JAX package.

Patterns (needles, delimiters, replacements) must be literals on the
device, and a pattern that can overlap itself stays on the host (matches
must then be taken in order); so do a regular expression outside the
literal and one-character-class subset, and a string function of a
non-string input.  The host twins (``cpu_eval``) are the JAX package's:
Python ``str`` operations over characters where the device counts bytes
(the two agree on ASCII).  Dictionary-encoded columns are not ported: the
port's batches always hold materialized strings.
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


#: offsets are int32: a built column's byte capacity stays below 2^31
MAX_BYTE_CAP = (1 << 31) - 1


def build_string(new_lens: torch.Tensor, src_fn, out_byte_cap: int,
                 validity: torch.Tensor) -> DevVal:
    """A string column from per-row output lengths (the JAX package's
    ``build_string``): offsets from one cumsum of ``new_lens``, then
    ``src_fn(rows, pos_in_row)`` gives every output byte from its row
    (``rows``: int64, each byte's row from ``rows_of_positions``) and its
    position in the row.  ``out_byte_cap`` is the JAX package's static
    capacity; bytes past the new total are 0."""
    if out_byte_cap > MAX_BYTE_CAP:
        raise ValueError(f"a built string column of {out_byte_cap} bytes "
                         "does not fit int32 offsets")
    dev = validity.device
    cap = int(new_lens.shape[0])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(new_lens, 0, dtype=torch.int32)])
    pos = torch.arange(out_byte_cap, dtype=torch.int32, device=dev)
    rows = cuda_tier.rows_of_positions(offsets, out_byte_cap) \
        .clamp_(0, cap - 1).long()
    data = src_fn(rows, pos - offsets[rows])
    data = torch.where(pos < offsets[-1], data, 0).to(torch.uint8)
    return DevVal(T.STRING, data, validity, offsets)


def _gather_substring(v: DevVal, starts: torch.Tensor, new_lens: torch.Tensor,
                      out_byte_cap: int, validity: torch.Tensor) -> DevVal:
    """A string column whose row r is bytes ``[starts[r], starts[r] +
    new_lens[r])`` of input row r: one gather through
    :func:`build_string`."""
    src_base = v.offsets[:-1] + starts
    last = int(v.data.shape[0]) - 1

    def src(rows, pos):
        return v.data[(src_base[rows] + pos).clamp_(0, last).long()]

    return build_string(new_lens, src, out_byte_cap, validity)


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
        n = torch.where(v.validity & ctx.row_mask, n, 0)
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


# ---------------------------------------------------------------------------
# the rest of the string functions (built on the device by build_string)
# ---------------------------------------------------------------------------


class _RowFlags:
    """Each row's flagged bytes (match starts, kept bytes) by one prefix
    count: the bytes lie in row order, so a row's flags are a run of the
    prefix and its k-th flag one ``searchsorted`` into it (no scatter, no
    atomics; the JAX package takes segment reductions)."""

    def __init__(self, v: DevVal, flags: torch.Tensor):
        nbytes = int(v.data.shape[0])
        dev = flags.device
        #: flags before each position, [nbytes + 1]
        self.prefix = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32)])
        self.start = v.offsets[:-1].clamp(0, nbytes)
        self.before = self.prefix[self.start.long()]
        self.count = self.prefix[v.offsets[1:].clamp(0, nbytes).long()] - \
            self.before

    def nth(self, k) -> torch.Tensor:
        """The byte position of each row's k-th flag (0-based; an int or
        a per-row tensor), ``NONE`` where the row has no such flag."""
        at = torch.searchsorted(self.prefix[1:], self.before + k + 1,
                                out_int32=True)
        ok = self.count > k
        if isinstance(k, torch.Tensor):
            ok &= k >= 0
        return torch.where(ok, at, NONE)

    def rank(self, rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Each byte's count of flags before it in its row."""
        return self.prefix[pos.long()] - self.before[rows]


#: a row's missing flag position (the JAX package's segment-min identity)
NONE = 1 << 30


def _byte_rows(v: DevVal):
    """(rows int64, pos int32, pos_in_row int32) of every byte of ``v``:
    its row (clamped into the capacity), its position, its position in
    its row."""
    cap = int(v.validity.shape[0])
    nbytes = int(v.data.shape[0])
    rows = cuda_tier.rows_of_positions(v.offsets, nbytes) \
        .clamp_(0, cap - 1).long()
    pos = torch.arange(nbytes, dtype=torch.int32, device=v.data.device)
    return rows, pos, pos - v.offsets[rows]


def _not_string(e: Expression) -> Optional[str]:
    """The reason a string function stays on the host where its input is
    not a string (the JAX package's device form reads string bytes the
    input does not have; its host twin converts)."""
    if not e.dtype.is_string:
        return f"the input is {e.dtype}, not a string"
    return None


class Length(UnaryExpression):
    """length(str): bytes on the device, characters on the host (the JAX
    package's two forms; they agree on ASCII)."""

    def _resolve_type(self):
        self.dtype = T.INT
        self.nullable = self.child.nullable

    def gpu_supported(self, conf):
        return _not_string(self.child)

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.INT, string_lengths(v), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        data = np.fromiter((len(str(s)) for s in v.values), dtype=np.int32,
                           count=len(v.values))
        return CpuVal(T.INT, data, v.validity)


class _CaseMap(UnaryExpression):
    """A byte map over ASCII letters that keeps the offsets."""

    def _resolve_type(self):
        self.dtype = T.STRING
        self.nullable = self.child.nullable

    def gpu_supported(self, conf):
        return _not_string(self.child)

    def _map_dev(self, v: DevVal) -> torch.Tensor:
        raise NotImplementedError

    def _map_cpu(self, s: str) -> str:
        raise NotImplementedError

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        return DevVal(T.STRING, self._map_dev(v), v.validity, v.offsets)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        out = np.array([self._map_cpu(str(s)) for s in v.values],
                       dtype=object)
        return CpuVal(T.STRING, out, v.validity)


class Upper(_CaseMap):
    def _map_dev(self, v):
        d = v.data
        return torch.where((d >= 97) & (d <= 122), d - 32, d)

    def _map_cpu(self, s):
        return "".join(c.upper() if "a" <= c <= "z" else c for c in s)


class Lower(_CaseMap):
    def _map_dev(self, v):
        d = v.data
        return torch.where((d >= 65) & (d <= 90), d + 32, d)

    def _map_cpu(self, s):
        return "".join(c.lower() if "A" <= c <= "Z" else c for c in s)


class InitCap(_CaseMap):
    """initcap: every ASCII letter lower case but the first of each word
    (a row's first byte, or a byte after a space), which is upper case."""

    def _map_dev(self, v):
        d = v.data
        nbytes = int(d.shape[0])
        head = torch.zeros(nbytes + 1, dtype=torch.bool, device=d.device)
        head[v.offsets.clamp(0, nbytes).long()] = True
        head = head[:nbytes]
        head[1:] |= d[:-1] == 32
        head[:1] = True
        is_upper = (d >= 65) & (d <= 90)
        is_lower = (d >= 97) & (d <= 122)
        return torch.where(head & is_lower, d - 32,
                           torch.where(~head & is_upper, d + 32, d))

    def _map_cpu(self, s):
        out = []
        head = True
        for ch in s:
            if head and "a" <= ch <= "z":
                out.append(chr(ord(ch) - 32))
            elif not head and "A" <= ch <= "Z":
                out.append(chr(ord(ch) + 32))
            else:
                out.append(ch)
            head = ch == " "
        return "".join(out)


class _Trim(UnaryExpression):
    """Spaces (byte 32 only) off the left, the right or both ends."""

    _left = True
    _right = True

    def _resolve_type(self):
        self.dtype = T.STRING
        self.nullable = self.child.nullable

    def gpu_supported(self, conf):
        return _not_string(self.child)

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        nbytes = int(v.data.shape[0])
        lens = string_lengths(v)
        pos = torch.arange(nbytes, dtype=torch.int32, device=v.data.device)
        kept = _RowFlags(v, (v.data != 32) & (pos < v.offsets[-1]))
        some = kept.count > 0
        lead = torch.where(some, kept.nth(0) - kept.start, lens) \
            if self._left else torch.zeros_like(lens)
        if self._right:
            last = kept.nth(kept.count - 1) - kept.start
            trail = torch.where(some, lens - 1 - last, lens)
        else:
            trail = torch.zeros_like(lens)
        new_lens = (lens - lead - trail).clamp(min=0)
        new_lens = torch.where(v.validity & ctx.row_mask, new_lens, 0)
        return _gather_substring(v, lead, new_lens, nbytes, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        if self._left and self._right:
            fn = lambda s: s.strip(" ")  # noqa: E731
        elif self._left:
            fn = lambda s: s.lstrip(" ")  # noqa: E731
        else:
            fn = lambda s: s.rstrip(" ")  # noqa: E731
        out = np.array([fn(str(s)) for s in v.values], dtype=object)
        return CpuVal(T.STRING, out, v.validity)


class StringTrim(_Trim):
    _left, _right = True, True


class StringTrimLeft(_Trim):
    _left, _right = True, False


class StringTrimRight(_Trim):
    _left, _right = False, True


def _concat2(a: DevVal, b: DevVal, ctx) -> DevVal:
    """Row by row a then b, NULL where either is; byte capacity the sum of
    the two."""
    la, lb = string_lengths(a), string_lengths(b)
    validity = a.validity & b.validity
    new_lens = torch.where(validity & ctx.row_mask, la + lb, 0)
    na, nb = int(a.data.shape[0]), int(b.data.shape[0])
    a_base, b_base = a.offsets[:-1], b.offsets[:-1]

    def src(rows, pos):
        lr = la[rows]
        ia = (a_base[rows] + pos).clamp_(0, na - 1).long()
        ib = (b_base[rows] + pos - lr).clamp_(0, nb - 1).long()
        return torch.where(pos < lr, a.data[ia], b.data[ib])

    return build_string(new_lens, src, na + nb, validity)


class ConcatStrings(Expression):
    """concat(a, b, ...) over strings; NULL where any input is (Spark)."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)
        self.dtype = T.STRING
        self.nullable = any(c.nullable for c in children)

    def with_children(self, children):
        return ConcatStrings(*children)

    def gpu_supported(self, conf):
        for c in self.children:
            r = _not_string(c)
            if r:
                return r
        return None

    def gpu_eval(self, ctx) -> DevVal:
        vals = [c.gpu_eval(ctx) for c in self.children]
        acc = vals[0]
        for v in vals[1:]:
            acc = _concat2(acc, v, ctx)
        return acc

    def cpu_eval(self, ctx) -> CpuVal:
        vals = [c.cpu_eval(ctx) for c in self.children]
        n = ctx.num_rows
        validity = np.ones(n, dtype=np.bool_)
        for v in vals:
            validity &= v.validity
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = "".join(str(v.values[i]) for v in vals) \
                if validity[i] else ""
        return CpuVal(T.STRING, out, validity)


class StringLocate(Expression):
    """locate(needle, str): the 1-based position of the first match, 0 if
    none (bytes on the device, characters on the host)."""

    def __init__(self, needle: Expression, child: Expression):
        if not isinstance(needle, Expression):
            needle = Literal(str(needle), T.STRING)
        self.children = (needle, child)
        self.dtype = T.INT
        self.nullable = child.nullable

    def with_children(self, children):
        return StringLocate(children[0], children[1])

    def gpu_supported(self, conf):
        if _literal_needle(self.children[0]) is None:
            return "locate needle must be a literal for GPU execution"
        return _not_string(self.children[1])

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[1].gpu_eval(ctx)
        needle = _literal_needle(self.children[0]).encode("utf-8")
        cap = int(v.validity.shape[0])
        if not needle:
            return DevVal(T.INT, torch.ones(cap, dtype=torch.int32,
                                            device=v.data.device),
                          v.validity)
        found = _RowFlags(v, cuda_tier._find_matches(v.data, v.offsets,
                                                     needle))
        data = torch.where(found.count > 0, found.nth(0) - found.start + 1,
                           0).to(torch.int32)
        return DevVal(T.INT, data, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[1].cpu_eval(ctx)
        needle = str(_literal_needle(self.children[0]) or "")
        data = np.fromiter((str(s).find(needle) + 1 for s in v.values),
                           dtype=np.int32, count=len(v.values))
        return CpuVal(T.INT, data, v.validity)


def _has_self_overlap(needle: bytes) -> bool:
    """True if the pattern can match at two positions closer than its
    length (then matches must be taken in order, which the device's
    independent per-byte tests cannot)."""
    return any(needle[k:] == needle[:-k] for k in range(1, len(needle)))


def _replace_match_starts(v: DevVal, match: torch.Tensor, ls: int,
                          repl: bytes, ctx) -> DevVal:
    """Every ``ls``-byte run starting at a True of ``match`` (starts inside
    their row, never overlapping) replaced by ``repl``: the copied bytes
    and the replacement bytes are scattered to their input positions
    shifted by ``len(repl) - ls`` for each earlier match of the row.  The
    byte capacity is the JAX package's static one (the input's, plus
    ``(nbytes // ls) * (len(repl) - ls)`` where the rows can grow)."""
    nbytes = int(v.data.shape[0])
    lr = len(repl)
    rows, pos, pos_in_row = _byte_rows(v)
    starts = _RowFlags(v, match)
    rank, csum = starts.rank(rows, pos), starts.prefix
    new_lens = string_lengths(v) + starts.count * (lr - ls)
    new_lens = torch.where(v.validity & ctx.row_mask, new_lens, 0)
    out_cap = nbytes if lr <= ls else nbytes + (nbytes // ls) * (lr - ls)
    if out_cap > MAX_BYTE_CAP:
        raise ValueError(f"a built string column of {out_cap} bytes does "
                         "not fit int32 offsets")
    # byte i is replaced where a match starts in (i - ls, i]
    lo = (pos - ls + 1).clamp(min=0).long()
    covered = (csum[pos.long() + 1] - csum[lo]) > 0
    out_offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=pos.device),
        torch.cumsum(new_lens, 0, dtype=torch.int32)])
    out_at = (out_offsets[rows] + pos_in_row + rank * (lr - ls)).long()
    # the bytes of live valid rows only: a dead row's bytes (a row past
    # take_head's count still owns its bytes) would land past the total
    in_data = (pos < v.offsets[-1]) & (v.validity & ctx.row_mask)[rows]
    out = torch.zeros(out_cap + 1, dtype=torch.uint8, device=pos.device)
    keep = in_data & ~covered
    out[torch.where(keep, out_at, out_cap)] = v.data
    starts = match & in_data
    for k, b in enumerate(repl):
        out[torch.where(starts, out_at + k, out_cap)] = b
    return DevVal(T.STRING, out[:out_cap], v.validity, out_offsets)


class StringReplace(Expression):
    """replace(str, search, replacement) with literal search and
    replacement."""

    def __init__(self, child: Expression, search, replacement):
        if not isinstance(search, Expression):
            search = Literal(str(search), T.STRING)
        if not isinstance(replacement, Expression):
            replacement = Literal(str(replacement), T.STRING)
        self.children = (child, search, replacement)
        self.dtype = T.STRING
        self.nullable = child.nullable

    def with_children(self, children):
        return StringReplace(*children)

    def gpu_supported(self, conf):
        s = _literal_needle(self.children[1])
        if s is None or _literal_needle(self.children[2]) is None:
            return "replace search/replacement must be literals for GPU"
        if s == "":
            return "replace with empty search is a no-op handled on CPU"
        if _has_self_overlap(s.encode("utf-8")):
            return ("replace search pattern can self-overlap; sequential "
                    "matching required (CPU only)")
        return _not_string(self.children[0])

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        search = _literal_needle(self.children[1]).encode("utf-8")
        repl = _literal_needle(self.children[2]).encode("utf-8")
        match = cuda_tier._find_matches(v.data, v.offsets, search)
        return _replace_match_starts(v, match, len(search), repl, ctx)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        search = str(_literal_needle(self.children[1]) or "")
        repl = str(_literal_needle(self.children[2]) or "")
        if search == "":
            out = np.array([str(s) for s in v.values], dtype=object)
        else:
            out = np.array([str(s).replace(search, repl)
                            for s in v.values], dtype=object)
        return CpuVal(T.STRING, out, v.validity)


class _Pad(Expression):
    """lpad/rpad to ``length`` with a one-byte pad; a longer row is cut
    to ``length``.  Byte capacity ``cap * length`` (at least 16)."""

    _left = True

    def __init__(self, child: Expression, length: int, pad: str = " "):
        self.children = (child,)
        self.target = int(length)
        self.pad = str(pad)
        self.dtype = T.STRING
        self.nullable = child.nullable

    def with_children(self, children):
        return type(self)(children[0], self.target, self.pad)

    def gpu_supported(self, conf):
        if len(self.pad.encode("utf-8")) != 1:
            return "multi-char pad strings not supported on GPU yet"
        return _not_string(self.children[0])

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        cap = int(v.validity.shape[0])
        nbytes = int(v.data.shape[0])
        lens = string_lengths(v)
        tgt = self.target
        new_lens = torch.where(v.validity & ctx.row_mask, tgt, 0) \
            .to(torch.int32)
        pad_b = self.pad.encode("utf-8")[0]
        npad = (tgt - lens).clamp(min=0)
        base = v.offsets[:-1]

        def src(rows, pos):
            if self._left:
                is_pad = pos < npad[rows]
                at = base[rows] + pos - npad[rows]
            else:
                is_pad = pos >= lens[rows]
                at = base[rows] + pos
            byte = v.data[at.clamp_(0, nbytes - 1).long()]
            return torch.where(is_pad, pad_b, byte)

        return build_string(new_lens, src, max(cap * max(tgt, 1), 16),
                            v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        out = np.empty(len(v.values), dtype=object)
        t, p = self.target, self.pad
        for i, s in enumerate(v.values):
            s = str(s)
            if len(s) >= t:
                out[i] = s[:t]
            elif self._left:
                out[i] = (p * t + s)[-t:] if p else s
            else:
                out[i] = (s + p * t)[:t] if p else s
        return CpuVal(T.STRING, out, v.validity)


class StringLPad(_Pad):
    _left = True


class StringRPad(_Pad):
    _left = False


_REGEX_META = set(".^$*+?()[]{}|\\")


def _regex_as_literal(pattern: str) -> Optional[str]:
    """The literal a regular expression matches exactly, or None where it
    uses an unescaped metacharacter or a class escape (``\\d``)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            if i + 1 >= len(pattern) or pattern[i + 1] not in _REGEX_META:
                return None
            out.append(pattern[i + 1])
            i += 2
            continue
        if ch in _REGEX_META:
            return None
        out.append(ch)
        i += 1
    return "".join(out)


def _regex_as_byte_class(pattern: str) -> Optional[bytes]:
    """The sorted bytes a one-character ASCII class (``[abc]``,
    ``[a-z0-9]``, escaped members and range ends) matches, or None (a
    negated class, anything else)."""
    if len(pattern) < 3 or pattern[0] != "[" or pattern[-1] != "]":
        return None
    inner = pattern[1:-1]
    if inner.startswith("^") or not inner:
        return None

    def item(i):
        ch = inner[i]
        if ch == "\\":
            if i + 1 >= len(inner):
                return None
            nxt = inner[i + 1]
            if nxt not in _REGEX_META and nxt != "-":
                return None
            return nxt, i + 2
        return ch, i + 1

    members = set()
    i = 0
    while i < len(inner):
        it = item(i)
        if it is None:
            return None
        lo_ch, i = it
        if i < len(inner) and inner[i] == "-" and i + 1 < len(inner):
            hi = item(i + 1)
            if hi is None:
                return None
            hi_ch, i = hi
            if ord(lo_ch) > ord(hi_ch) or ord(hi_ch) > 127:
                return None
            members.update(range(ord(lo_ch), ord(hi_ch) + 1))
            continue
        if ord(lo_ch) > 127:
            return None
        members.add(ord(lo_ch))
    return bytes(sorted(members)) if members else None


class RegExpReplace(Expression):
    """regexp_replace(str, pattern, replacement): on the device where the
    pattern is a literal (after unescaping; the replace path) or a
    one-character ASCII class (every member byte a one-byte match); any
    other pattern on the host through ``re`` with a literal
    replacement."""

    def __init__(self, child: Expression, pattern, replacement):
        if not isinstance(pattern, Expression):
            pattern = Literal(str(pattern), T.STRING)
        if not isinstance(replacement, Expression):
            replacement = Literal(str(replacement), T.STRING)
        self.children = (child, pattern, replacement)
        self.dtype = T.STRING
        self.nullable = child.nullable

    def with_children(self, children):
        return RegExpReplace(*children)

    def _plan(self):
        pat = _literal_needle(self.children[1])
        if pat is None or _literal_needle(self.children[2]) is None:
            return None
        lit = _regex_as_literal(pat)
        if lit:
            return ("literal", lit)
        cls = _regex_as_byte_class(pat)
        return ("class", cls) if cls is not None else None

    def gpu_supported(self, conf):
        plan = self._plan()
        if plan is None:
            return ("regexp pattern is not in the transpilable subset "
                    "(literal or single-char class); CPU fallback")
        if plan[0] == "literal" and \
                _has_self_overlap(plan[1].encode("utf-8")):
            return ("regexp literal can self-overlap; sequential matching "
                    "required (CPU only)")
        return _not_string(self.children[0])

    def gpu_eval(self, ctx) -> DevVal:
        kind, what = self._plan()
        v = self.children[0].gpu_eval(ctx)
        repl = _literal_needle(self.children[2]).encode("utf-8")
        if kind == "literal":
            lit = what.encode("utf-8")
            match = cuda_tier._find_matches(v.data, v.offsets, lit)
            return _replace_match_starts(v, match, len(lit), repl, ctx)
        member = torch.zeros(256, dtype=torch.bool, device=v.data.device)
        member[list(what)] = True
        nbytes = int(v.data.shape[0])
        in_data = torch.arange(nbytes, dtype=torch.int32,
                               device=v.data.device) < v.offsets[-1]
        match = member[v.data.long()] & in_data
        return _replace_match_starts(v, match, 1, repl, ctx)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        pat = _literal_needle(self.children[1])
        repl = _literal_needle(self.children[2])
        if pat is None or repl is None:
            raise NotImplementedError(
                "regexp_replace pattern/replacement must be literals")
        rx = re.compile(pat)
        # a literal replacement: Java's $-group references are not
        # supported (Python's \-templates would expand)
        out = np.array([rx.sub(lambda _m: repl, str(s)) for s in v.values],
                       dtype=object)
        return CpuVal(T.STRING, out, v.validity)


class SplitPart(Expression):
    """split_part(str, delimiter, partNum): the 1-based field between
    literal delimiters, '' out of range (Spark ``split_part``)."""

    def __init__(self, child: Expression, delimiter, part):
        if not isinstance(delimiter, Expression):
            delimiter = Literal(str(delimiter), T.STRING)
        self.children = (child, delimiter)
        self.part = int(part)
        if self.part == 0:
            raise ValueError("split_part: partNum must not be 0")
        self.dtype = T.STRING
        self.nullable = child.nullable

    def with_children(self, children):
        return SplitPart(children[0], children[1], self.part)

    def gpu_supported(self, conf):
        d = _literal_needle(self.children[1])
        if d is None or d == "":
            return "split delimiter must be a non-empty literal"
        if self.part < 0:
            return "negative part numbers run on CPU"
        if _has_self_overlap(d.encode("utf-8")):
            return "split delimiter can self-overlap (CPU only)"
        return _not_string(self.children[0])

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        delim = _literal_needle(self.children[1]).encode("utf-8")
        j = self.part - 1
        found = _RowFlags(v, cuda_tier._find_matches(v.data, v.offsets,
                                                     delim))
        row_start, row_end = v.offsets[:-1], v.offsets[1:]
        start = row_start if j == 0 else torch.minimum(
            found.nth(j - 1) + len(delim), row_end)
        end = torch.where(found.count > j, found.nth(j), row_end)
        new_lens = torch.where(found.count >= j, (end - start).clamp(min=0),
                               0)
        new_lens = torch.where(v.validity & ctx.row_mask, new_lens, 0)
        return _gather_substring(v, start - row_start, new_lens,
                                 int(v.data.shape[0]), v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        d = _literal_needle(self.children[1])
        if d is None:
            raise NotImplementedError(
                "split_part delimiter must be a literal")
        out = np.empty(len(v.values), dtype=object)
        for i, s in enumerate(v.values):
            parts = str(s).split(d) if d else [str(s)]
            k = self.part
            if k < 0:
                k = len(parts) + k + 1
            out[i] = parts[k - 1] if 1 <= k <= len(parts) else ""
        return CpuVal(T.STRING, out, v.validity)


class ConcatWs(Expression):
    """concat_ws(sep, cols...): the non-NULL values joined by a literal
    separator; never NULL.  Each step's byte capacity is the two inputs'
    plus one separator a row."""

    def __init__(self, sep, *children: Expression):
        self.sep = str(sep)
        self.children = tuple(children)
        self.dtype = T.STRING
        self.nullable = False

    def with_children(self, children):
        return ConcatWs(self.sep, *children)

    def gpu_supported(self, conf):
        for c in self.children:
            if not c.dtype.is_string:
                return f"concat_ws child must be string, got {c.dtype}"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        cap, dev = ctx.capacity, ctx.device
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        if not self.children:
            return DevVal(T.STRING, torch.zeros(16, dtype=torch.uint8,
                                                device=dev), ones,
                          torch.zeros(cap + 1, dtype=torch.int32,
                                      device=dev))
        sep = self.sep.encode("utf-8")
        ls = len(sep)
        sep_t = torch.tensor(list(sep) or [0], dtype=torch.uint8,
                             device=dev)
        vals = [c.gpu_eval(ctx) for c in self.children]
        first = vals[0]
        acc = _gather_substring(
            first, torch.zeros(cap, dtype=torch.int32, device=dev),
            torch.where(first.validity & ctx.row_mask,
                        string_lengths(first), 0),
            int(first.data.shape[0]), ones)
        has_any = first.validity
        for v in vals[1:]:
            la = string_lengths(acc)
            add_sep = has_any & v.validity
            v_start = la + torch.where(add_sep, ls, 0)
            new_lens = torch.where(v.validity,
                                   v_start + string_lengths(v), la)
            new_lens = torch.where(ctx.row_mask, new_lens, 0)
            na, nv = int(acc.data.shape[0]), int(v.data.shape[0])

            def src(rows, pos, acc=acc, v=v, la=la, v_start=v_start,
                    na=na, nv=nv):
                lar, vs = la[rows], v_start[rows]
                ia = (acc.offsets[:-1][rows] + pos).clamp_(0, na - 1).long()
                iv = (v.offsets[:-1][rows] + pos - vs).clamp_(0, nv - 1) \
                    .long()
                isep = (pos - lar).clamp_(0, max(ls - 1, 0)).long()
                return torch.where(pos < lar, acc.data[ia],
                                   torch.where(pos < vs, sep_t[isep],
                                               v.data[iv]))

            acc = build_string(new_lens, src, na + nv + cap * ls, ones)
            has_any = has_any | v.validity
        return acc

    def cpu_eval(self, ctx) -> CpuVal:
        vals = [c.cpu_eval(ctx) for c in self.children]
        n = ctx.num_rows
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = self.sep.join(str(v.values[i]) for v in vals
                                   if v.validity[i])
        return CpuVal(T.STRING, out, np.ones(n, dtype=np.bool_))


class SubstringIndex(Expression):
    """substring_index(str, delim, count): what lies before the count-th
    delimiter (count > 0) or after the |count|-th from the right (count <
    0); the whole row where there are fewer delimiters."""

    def __init__(self, child: Expression, delimiter, count: int):
        if not isinstance(delimiter, Expression):
            delimiter = Literal(str(delimiter), T.STRING)
        self.children = (child, delimiter)
        self.count = int(count)
        self.dtype = T.STRING
        self.nullable = child.nullable

    def with_children(self, children):
        return SubstringIndex(children[0], children[1], self.count)

    def gpu_supported(self, conf):
        d = _literal_needle(self.children[1])
        if d is None or d == "":
            return "substring_index delimiter must be a non-empty literal"
        if _has_self_overlap(d.encode("utf-8")):
            return "substring_index delimiter can self-overlap (CPU only)"
        return _not_string(self.children[0])

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        delim = _literal_needle(self.children[1]).encode("utf-8")
        cap = int(v.validity.shape[0])
        nbytes = int(v.data.shape[0])
        row_start, row_end = v.offsets[:-1], v.offsets[1:]
        if self.count == 0:
            zero = torch.zeros(cap, dtype=torch.int32, device=v.data.device)
            return _gather_substring(v, zero, zero, nbytes, v.validity)
        found = _RowFlags(v, cuda_tier._find_matches(v.data, v.offsets,
                                                     delim))
        n_matches = found.count
        if self.count > 0:
            start = row_start
            end = torch.where(n_matches >= self.count,
                              found.nth(self.count - 1), row_end)
        else:
            start = torch.where(n_matches >= -self.count,
                                found.nth(n_matches + self.count)
                                + len(delim), row_start)
            end = row_end
        new_lens = torch.where(v.validity & ctx.row_mask,
                               (end - start).clamp(min=0), 0)
        return _gather_substring(v, start - row_start, new_lens, nbytes,
                                 v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        d = _literal_needle(self.children[1])
        if d is None:
            raise NotImplementedError(
                "substring_index delimiter must be a literal")
        c = self.count
        out = np.empty(len(v.values), dtype=object)
        for i, s in enumerate(v.values):
            s = str(s)
            if c == 0 or not d:
                out[i] = ""
                continue
            parts = s.split(d)
            if c > 0:
                out[i] = d.join(parts[:c]) if len(parts) > c else s
            else:
                out[i] = d.join(parts[c:]) if len(parts) > -c else s
        return CpuVal(T.STRING, out, v.validity)


class StringSplit(Expression):
    """split(str, delimiter) -> array<string>, the delimiter a regular
    expression (Spark's ``split``).  The device's arrays hold fixed-width
    elements only, so this node runs on the host in both packages."""

    def __init__(self, child: Expression, delimiter):
        if not isinstance(delimiter, Expression):
            delimiter = Literal(str(delimiter), T.STRING)
        self.children = (child, delimiter)
        self.dtype = T.ArrayType(T.STRING)
        self.nullable = child.nullable

    def with_children(self, children):
        return StringSplit(children[0], children[1])

    def gpu_supported(self, conf):
        return ("split produces array<string>; variable-length array "
                "elements are CPU-only")

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.children[0].cpu_eval(ctx)
        d = _literal_needle(self.children[1])
        if d is None:
            raise NotImplementedError("split delimiter must be a literal")
        pat = re.compile(d) if d else None
        out = np.empty(len(v.values), dtype=object)
        for i, s in enumerate(v.values):
            out[i] = pat.split(str(s)) if pat else [str(s)]
        return CpuVal(self.dtype, out, v.validity)


class Hex(UnaryExpression):
    """hex(integral) -> upper-case hex digits; a negative value as 16
    digits of its two's complement.  The device takes the 16 nibbles by
    arithmetic shifts and gathers from the first non-zero one (byte
    capacity ``cap * 16``).  The host twin also takes strings (the hex of
    their UTF-8 bytes) and floats (cast to LONG first), which stay on the
    host."""

    def _resolve_type(self):
        self.dtype = T.STRING
        self.nullable = self.child.nullable

    def gpu_supported(self, conf):
        if self.child.dtype != T.NULL and not self.child.dtype.is_integral:
            return "hex over non-integral inputs runs on CPU"
        return None

    def gpu_eval(self, ctx) -> DevVal:
        v = self.child.gpu_eval(ctx)
        cap, dev = ctx.capacity, ctx.device
        x = v.data.to(torch.int64)
        shifts = torch.arange(60, -1, -4, dtype=torch.int64, device=dev)
        nibbles = (x[:, None] >> shifts[None, :]) & 15       # [cap, 16]
        digits = torch.where(nibbles < 10, nibbles + 48, nibbles + 55) \
            .to(torch.uint8)
        nz = nibbles != 0
        first = nz.to(torch.uint8).argmax(dim=1).to(torch.int32)
        any_nz = nz.any(dim=1)
        lens = torch.where(any_nz, 16 - first, 1).to(torch.int32)
        lens = torch.where(v.validity & ctx.row_mask, lens, 0)
        v16 = DevVal(T.STRING, digits.reshape(-1), v.validity,
                     torch.arange(cap + 1, dtype=torch.int32,
                                  device=dev) * 16)
        return _gather_substring(v16, torch.where(any_nz, first, 15), lens,
                                 cap * 16, v.validity)

    def cpu_eval(self, ctx) -> CpuVal:
        v = self.child.cpu_eval(ctx)
        out = np.empty(len(v.values), dtype=object)
        dt = self.child.dtype
        for i, x in enumerate(v.values):
            if dt.is_string:
                out[i] = str(x).encode("utf-8").hex().upper()
                continue
            if dt.is_fractional:
                # Spark's double -> bigint cast: toward zero, NaN 0, the
                # long bounds past them
                xf = float(x)
                if xf != xf:
                    xi = 0
                elif xf >= 2.0 ** 63:
                    xi = (1 << 63) - 1
                elif xf < -(2.0 ** 63):
                    xi = -(1 << 63)
                else:
                    xi = int(xf)
            else:
                xi = int(x)
            out[i] = format(xi if xi >= 0 else xi + (1 << 64), "X")
        return CpuVal(T.STRING, out, v.validity)
