"""Attribute filtering for the sharded index (Milvus boolean-expr analog).

A verbatim copy of ``image_retrieval_tpu/index/filters.py`` (that
package's ``index/__init__`` imports jax, so the port cannot import it);
tests/test_torch_filters.py pins the code of the two copies together.
In the port the evaluated mask replaces ``valid`` on the device the same
way, as a bool tensor cached per (expression, generation).

Milvus searches and queries accept a boolean expression over scalar
fields (`expr="color == 'red' and views >= 100"`). The reference only
ever stores path/embedding/magnitude (ImageEmbeddingSystem.py:41-47) and
queries with the trivial `id >= 0` (image_search.py 'query' usage), but a
production vector DB needs the general form, so this module provides it
TPU-first:

- scalar attributes live host-side as dense columns (strings are
  dictionary-encoded to int32 codes — no object arrays);
- a filter expression is parsed once and evaluated VECTORIZED over the
  columns into one (N,) bool mask;
- the mask is ANDed with the tombstone mask and shipped to the device
  sharded exactly like `valid`, where it rides the SAME masked-scan jit
  the tombstone path uses (parallel/collectives.py: excluded rows score
  -inf before top-k). No gathers, no new compiles per expression, and
  the sharded device mask is cached per (expression, index generation)
  so repeated serving traffic with the same filter costs nothing.

Grammar (a practical subset of Milvus's boolean expr):

    expr   := or
    or     := and  (("or"  | "||") and)*
    and    := unary (("and" | "&&") unary)*
    unary  := ("not" | "!") unary | "(" expr ")" | comparison
    comparison := field ("=="|"!="|"<"|"<="|">"|">=") literal
                | field "in" list | field "not" "in" list
    literal := int | float | 'str' | "str" | true | false
    list    := "[" literal ("," literal)* "]"

Keywords are case-insensitive. String comparisons support ==/!=/in/not in;
ordered comparisons require numeric columns.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["parse_filter", "AttributeStore", "FilterError"]


class FilterError(ValueError):
    """Raised for unparseable expressions or schema mismatches."""


# --------------------------------------------------------------------------
# Tokenizer / parser
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<op>==|!=|<=|>=|<|>|\(|\)|\[|\]|,|&&|\|\||!)
      | (?P<float>[-+]?\d+\.\d*(?:[eE][-+]?\d+)?|[-+]?\d+[eE][-+]?\d+)
      | (?P<int>[-+]?\d+)
      | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
      | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {"and", "or", "not", "in", "true", "false"}


def _tokenize(expr: str) -> List[Tuple[str, object]]:
    tokens: List[Tuple[str, object]] = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if m is None:
            if expr[pos:].strip() == "":
                break
            raise FilterError(
                f"filter: cannot tokenize {expr[pos:pos + 20]!r} "
                f"(position {pos})"
            )
        pos = m.end()
        if m.lastgroup == "op":
            tokens.append(("op", m.group("op")))
        elif m.lastgroup == "float":
            tokens.append(("num", float(m.group("float"))))
        elif m.lastgroup == "int":
            tokens.append(("num", float(m.group("int"))))
        elif m.lastgroup == "str":
            raw = m.group("str")
            body = raw[1:-1]
            body = re.sub(r"\\(.)", r"\1", body)
            tokens.append(("str", body))
        else:
            name = m.group("name")
            low = name.lower()
            if low in _KEYWORDS:
                if low == "true":
                    tokens.append(("num", 1.0))
                elif low == "false":
                    tokens.append(("num", 0.0))
                else:
                    tokens.append(("kw", low))
            else:
                tokens.append(("name", name))
    return tokens


class _Parser:
    """Recursive descent over the token list; produces nested tuples:
    ("or", l, r) / ("and", l, r) / ("not", x) /
    ("cmp", op, field, ("num"|"str", value)) /
    ("in", field, [values], negated: bool)."""

    def __init__(self, tokens: List[Tuple[str, object]], src: str):
        self.toks = tokens
        self.i = 0
        self.src = src

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", None)

    def take(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind: str, val=None):
        t = self.take()
        if t[0] != kind or (val is not None and t[1] != val):
            raise FilterError(
                f"filter: expected {val or kind} near token {self.i} "
                f"in {self.src!r}, got {t[1]!r}"
            )
        return t

    def parse(self):
        node = self.parse_or()
        if self.peek()[0] != "eof":
            raise FilterError(
                f"filter: trailing input from token {self.i} in {self.src!r}"
            )
        return node

    def parse_or(self):
        node = self.parse_and()
        while (self.peek() == ("kw", "or")) or (self.peek() == ("op", "||")):
            self.take()
            node = ("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_unary()
        while (self.peek() == ("kw", "and")) or (self.peek() == ("op", "&&")):
            self.take()
            node = ("and", node, self.parse_unary())
        return node

    def parse_unary(self):
        if self.peek() == ("kw", "not") or self.peek() == ("op", "!"):
            self.take()
            return ("not", self.parse_unary())
        if self.peek() == ("op", "("):
            self.take()
            node = self.parse_or()
            self.expect("op", ")")
            return node
        return self.parse_comparison()

    def _literal(self) -> Tuple[str, object]:
        t = self.take()
        if t[0] in ("num", "str"):
            return t
        raise FilterError(
            f"filter: expected a literal in {self.src!r}, got {t[1]!r}"
        )

    def parse_comparison(self):
        t = self.take()
        if t[0] != "name":
            raise FilterError(
                f"filter: expected a field name in {self.src!r}, got {t[1]!r}"
            )
        field = t[1]
        nxt = self.peek()
        if nxt == ("kw", "in"):
            self.take()
            return ("in", field, self._list(), False)
        if nxt == ("kw", "not"):
            self.take()
            self.expect("kw", "in")
            return ("in", field, self._list(), True)
        if nxt[0] == "op" and nxt[1] in ("==", "!=", "<", "<=", ">", ">="):
            op = self.take()[1]
            return ("cmp", op, field, self._literal())
        raise FilterError(
            f"filter: expected a comparison operator after {field!r} "
            f"in {self.src!r}"
        )

    def _list(self) -> List[Tuple[str, object]]:
        self.expect("op", "[")
        vals = [self._literal()]
        while self.peek() == ("op", ","):
            self.take()
            vals.append(self._literal())
        self.expect("op", "]")
        return vals


def parse_filter(expr: str):
    """Parse a Milvus-style boolean expression into an AST (raises
    FilterError on syntax errors). The AST is a plain nested tuple —
    hashable, so callers can cache on it or on the source string."""
    if not isinstance(expr, str) or not expr.strip():
        raise FilterError("filter: empty expression")
    return _Parser(_tokenize(expr), expr).parse()


# --------------------------------------------------------------------------
# Attribute columns
# --------------------------------------------------------------------------


#: dictionary code for rows inserted without a string field. Distinct from
#: the unseen-literal code (-1) so `c == '<never inserted>'` cannot match
#: missing rows.
_MISSING_CODE = np.int32(-2)


class AttributeStore:
    """Per-row scalar attribute columns for the index.

    Numeric values are stored as float64 (ints are exact to 2**53);
    strings are dictionary-encoded into int32 codes with a per-column
    vocab. Fields are NULLABLE (like Milvus ≥2.5 nullable scalar fields):
    an insert may carry any subset of fields — or none — and rows that
    lack a field get a missing sentinel (NaN for numeric columns, a
    reserved code for string columns). A field first seen mid-lifetime is
    backfilled as missing for all earlier rows. Per-column value KIND
    (str vs numeric) is fixed by first use and enforced.

    Missing semantics: a missing value matches `!=` and `not in` and
    nothing else (==/</<=/>/>=/in are all False). `not <expr>` inverts
    the match like any boolean negation. Indexes that never pass attrs
    pay nothing.
    """

    def __init__(self):
        self.columns: Dict[str, np.ndarray] = {}
        self.kinds: Dict[str, str] = {}  # "num" | "str"
        self.vocab: Dict[str, Dict[str, int]] = {}
        self.rows = 0

    @property
    def fields(self) -> List[str]:
        return sorted(self.columns)

    def _encode_str(self, field: str, values: Sequence) -> np.ndarray:
        v = self.vocab.setdefault(field, {})
        codes = np.empty(len(values), np.int32)
        for i, s in enumerate(values):
            if s is None:
                codes[i] = _MISSING_CODE
                continue
            s = str(s)
            code = v.get(s)
            if code is None:
                code = len(v)
                v[s] = code
            codes[i] = code
        return codes

    @staticmethod
    def _missing(kind: str, n: int) -> np.ndarray:
        if kind == "str":
            return np.full(n, _MISSING_CODE, np.int32)
        return np.full(n, np.nan, np.float64)

    def append(self, attrs: Optional[Dict[str, Sequence]], n: int) -> None:
        """Validate + append n rows of attributes. Call BEFORE mutating the
        index so a bad attrs dict leaves both sides untouched. Fields are
        nullable: absent fields (or per-row None values) become missing
        sentinels; a brand-new field is backfilled as missing for all
        earlier rows."""
        encoded: Dict[str, Tuple[str, np.ndarray]] = {}
        for field, values in (attrs or {}).items():
            vals = list(values)
            if len(vals) != n:
                raise FilterError(
                    f"insert(): attrs[{field!r}] has {len(vals)} values "
                    f"for {n} rows"
                )
            want = self.kinds.get(field)
            has_str = any(isinstance(x, str) for x in vals)
            has_num = any(
                x is not None and not isinstance(x, str) for x in vals
            )
            if has_str and has_num:
                raise FilterError(
                    f"insert(): attrs[{field!r}] mixes strings and numbers"
                )
            kind = "str" if has_str else ("num" if has_num else want or "num")
            if want is not None and kind != want:
                raise FilterError(
                    f"insert(): attrs[{field!r}] is {kind} but the column "
                    f"is {want}"
                )
            if kind == "str":
                arr = self._encode_str(field, vals)
            else:
                arr = np.asarray(
                    [np.nan if x is None else float(x) for x in vals],
                    np.float64,
                )
            encoded[field] = (kind, arr)
        # all validated; commit
        for field, (kind, arr) in encoded.items():
            if field in self.columns:
                self.columns[field] = np.concatenate([self.columns[field], arr])
            else:  # new field: earlier rows are missing
                self.columns[field] = np.concatenate(
                    [self._missing(kind, self.rows), arr]
                )
                self.kinds[field] = kind
        for field in self.columns:  # fields this insert omitted
            if field not in encoded:
                self.columns[field] = np.concatenate(
                    [self.columns[field], self._missing(self.kinds[field], n)]
                )
        self.rows += n

    def take(self, keep: np.ndarray) -> None:
        """Compact: keep only the given row indices (in order)."""
        for field in self.columns:
            self.columns[field] = self.columns[field][keep]
        self.rows = int(len(keep))

    # -- evaluation ---------------------------------------------------------

    def _col(self, field: str, count: int, extra=None) -> Tuple[str, np.ndarray]:
        if extra and field in extra:
            kind, arr = extra[field]
            return kind, arr[:count]
        if field not in self.columns:
            known = self.fields + (sorted(extra) if extra else [])
            raise FilterError(
                f"filter: unknown field {field!r}; index has {known}"
            )
        return self.kinds[field], self.columns[field][:count]

    def _lit_code(self, field: str, lit: Tuple[str, object]) -> int:
        """String literal -> vocab code; unseen strings get -1 (matches
        nothing on ==, everything on !=)."""
        if lit[0] != "str":
            raise FilterError(
                f"filter: field {field!r} holds strings; compare with a "
                "quoted literal"
            )
        return self.vocab.get(field, {}).get(str(lit[1]), -1)

    def evaluate(self, ast, count: int, extra=None) -> np.ndarray:
        """AST -> (count,) bool mask, fully vectorized.

        `extra` maps a virtual field name -> (kind, array) consulted before
        the stored columns; kind "rawstr" compares python strings directly
        (used by the pymilvus shim for id / image_path exprs)."""
        kind = ast[0]
        if kind == "or":
            return (self.evaluate(ast[1], count, extra)
                    | self.evaluate(ast[2], count, extra))
        if kind == "and":
            return (self.evaluate(ast[1], count, extra)
                    & self.evaluate(ast[2], count, extra))
        if kind == "not":
            return ~self.evaluate(ast[1], count, extra)
        if kind == "in":
            _, field, lits, negated = ast
            ck, col = self._col(field, count, extra)
            if ck == "rawstr":
                vals = []
                for l in lits:
                    if l[0] != "str":
                        raise FilterError(
                            f"filter: field {field!r} holds strings"
                        )
                    vals.append(str(l[1]))
                mask = np.isin(col, np.asarray(vals, object))
                return ~mask if negated else mask
            if ck == "str":
                codes = [self._lit_code(field, l) for l in lits]
                mask = np.isin(col, np.asarray(codes, np.int32))
            else:
                vals = []
                for l in lits:
                    if l[0] != "num":
                        raise FilterError(
                            f"filter: field {field!r} is numeric; "
                            f"{l[1]!r} is a string"
                        )
                    vals.append(float(l[1]))
                mask = np.isin(col, np.asarray(vals, np.float64))
            return ~mask if negated else mask
        if kind == "cmp":
            _, op, field, lit = ast
            ck, col = self._col(field, count, extra)
            if ck == "rawstr":
                if op not in ("==", "!="):
                    raise FilterError(
                        f"filter: ordered comparison {op!r} is not defined "
                        f"for string field {field!r}"
                    )
                if lit[0] != "str":
                    raise FilterError(
                        f"filter: field {field!r} holds strings; compare "
                        "with a quoted literal"
                    )
                return (col == str(lit[1])) if op == "==" else (col != str(lit[1]))
            if ck == "str":
                if op not in ("==", "!="):
                    raise FilterError(
                        f"filter: ordered comparison {op!r} is not defined "
                        f"for string field {field!r}"
                    )
                code = self._lit_code(field, lit)
                return (col == code) if op == "==" else (col != code)
            if lit[0] != "num":
                raise FilterError(
                    f"filter: field {field!r} is numeric; {lit[1]!r} is a "
                    "string"
                )
            v = float(lit[1])
            if op == "==":
                return col == v
            if op == "!=":
                return col != v
            if op == "<":
                return col < v
            if op == "<=":
                return col <= v
            if op == ">":
                return col > v
            return col >= v
        raise FilterError(f"filter: unknown AST node {kind!r}")  # pragma: no cover

    # -- persistence ----------------------------------------------------------

    def to_arrays(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """(npz-ready arrays, json-ready meta) for index save()."""
        arrays = {f"attr__{k}": v for k, v in self.columns.items()}
        meta = {
            "kinds": self.kinds,
            "vocab": self.vocab,
            "rows": self.rows,
        }
        return arrays, meta

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray], meta: dict) -> "AttributeStore":
        st = cls()
        st.kinds = dict(meta.get("kinds", {}))
        st.vocab = {k: dict(v) for k, v in meta.get("vocab", {}).items()}
        st.rows = int(meta.get("rows", 0))
        for key, arr in arrays.items():
            name = key[len("attr__"):]
            st.columns[name] = np.asarray(arr)
        return st
