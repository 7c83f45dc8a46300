"""SQL lexer (a copy of ``spark_rapids_tpu/sql/lexer.py``: the same tokens
for the same text)."""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, List

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "is", "null", "like", "between",
    "join", "inner", "left", "right", "full", "outer", "semi", "anti",
    "cross", "on", "using", "union", "all", "distinct", "intersect",
    "except", "case", "when",
    "then", "else", "end", "asc", "desc", "nulls", "first", "last", "cast",
    "true", "false", "exists", "interval", "over", "partition", "rows",
    "range", "unbounded", "preceding", "following", "current", "row",
}

TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|\d+([eE][+-]?\d+)?)
  | (?P<string>'([^']|'')*')
  | (?P<qident>`[^`]+`|"[^"]+")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|<>|!=|==|\|\||[-+*/%(),.<>=])
""", re.VERBOSE)


@dataclasses.dataclass
class Token:
    kind: str  # keyword | ident | number | string | op | eof
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(sql):
        m = TOKEN_RE.match(sql, i)
        if not m:
            raise SyntaxError(f"cannot tokenize SQL at {sql[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "ident":
            low = text.lower()
            if low in KEYWORDS:
                out.append(Token("keyword", low, m.start()))
            else:
                out.append(Token("ident", text, m.start()))
        elif kind == "qident":
            out.append(Token("ident", text[1:-1], m.start()))
        elif kind == "string":
            out.append(Token("string", text[1:-1].replace("''", "'"),
                             m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out
