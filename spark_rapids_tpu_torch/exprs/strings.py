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

Patterns (needles) must be literals; the port has no CPU twins, so anything
else is refused by the planner.  Dictionary-encoded columns are not ported:
the port's batches always hold materialized strings.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs.base import DevVal, Expression, Literal
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

    def gpu_eval(self, ctx) -> DevVal:
        v = self.children[0].gpu_eval(ctx)
        data = self._match_dev(v, self.needle.encode("utf-8"))
        return DevVal(T.BOOLEAN, data, v.validity)


class StringStartsWith(_NeedlePredicate):
    def _match_dev(self, v, needle):
        return _match_prefix(v, needle)


class StringEndsWith(_NeedlePredicate):
    def _match_dev(self, v, needle):
        return _match_suffix(v, needle)


class StringContains(_NeedlePredicate):
    def _match_dev(self, v, needle):
        return _rows_with_match(v, needle)


class Like(Expression):
    """SQL LIKE restricted to patterns that translate to exact, prefix,
    suffix, contains or prefix-and-suffix tests: 'abc', 'abc%', '%abc',
    '%abc%', 'a%b' (and '%').  Other patterns ('_' wildcards, escapes,
    several inner '%') are refused by the planner."""

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
