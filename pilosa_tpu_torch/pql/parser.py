"""Hand-written recursive-descent PQL parser.

Copied whole from pilosa_tpu/pql/parser.py (pure Python).

Productions mirror the reference PEG grammar (pql/pql.peg) one-to-one; each
method is named after its production. Divergence from the reference, on
purpose: the int-range conditional `a < field < b` maps to a half-open
BETWEEN with *correct* bounds on both sides — the reference's endConditional
(pql/ast.go:82-102) increments the upper bound for `<=` instead of `<`,
an off-by-one on the upper bound fixed in later Pilosa releases; we
implement the intended semantics (BETWEEN value = inclusive [lo, hi]).
"""

from __future__ import annotations

import re
from datetime import datetime

from pilosa_tpu_torch.pql.ast import BETWEEN, Call, Condition, Query

TIMESTAMP_RE = re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d")
IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")
FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
RESERVED_FIELDS = ("_row", "_col", "_start", "_end", "_timestamp", "_field")
UINT_RE = re.compile(r"0|[1-9][0-9]*")
INT_RE = re.compile(r"-?(?:0|[1-9][0-9]*)")
NUM_RE = re.compile(r"-?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)")
BARE_STRING_RE = re.compile(r"[A-Za-z0-9\-_:]+")
COND_OPS = ("><", "<=", ">=", "==", "!=", "<", ">")

TIME_FORMAT = "%Y-%m-%dT%H:%M"


class PQLError(ValueError):
    def __init__(self, msg: str, pos: int, src: str):
        line = src.count("\n", 0, pos) + 1
        col = pos - (src.rfind("\n", 0, pos) + 1) + 1
        super().__init__(f"parse error at line {line}:{col}: {msg}")
        self.pos = pos


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0

    # -- low-level ----------------------------------------------------------

    def error(self, msg: str):
        raise PQLError(msg, self.pos, self.src)

    def eof(self) -> bool:
        return self.pos >= len(self.src)

    def peek(self, n: int = 1) -> str:
        return self.src[self.pos : self.pos + n]

    def sp(self) -> None:
        while not self.eof() and self.src[self.pos] in " \t\n":
            self.pos += 1

    def expect(self, tok: str) -> None:
        if not self.src.startswith(tok, self.pos):
            self.error(f"expected {tok!r}")
        self.pos += len(tok)

    def accept(self, tok: str) -> bool:
        if self.src.startswith(tok, self.pos):
            self.pos += len(tok)
            return True
        return False

    def comma(self) -> None:
        self.sp()
        self.expect(",")
        self.sp()

    def accept_comma(self) -> bool:
        save = self.pos
        self.sp()
        if self.accept(","):
            self.sp()
            return True
        self.pos = save
        return False

    def match(self, regex: re.Pattern):
        m = regex.match(self.src, self.pos)
        if m:
            self.pos = m.end()
            return m.group(0)
        return None

    # -- grammar ------------------------------------------------------------

    def parse(self) -> Query:
        calls = []
        self.sp()
        while not self.eof():
            calls.append(self.call())
            self.sp()
        return Query(calls)

    # nesting bound: recursive descent must fail with a clean parse error
    # on pathologically deep inputs, not let RecursionError escape as an
    # internal 500 (fuzz finding; ample for real queries — the reference's
    # deepest documented call trees are a handful of levels)
    MAX_DEPTH = 128

    def call(self) -> Call:
        self._depth = getattr(self, "_depth", 0) + 1
        start = self.pos
        try:
            if self._depth > self.MAX_DEPTH:
                self.error(f"query nested deeper than {self.MAX_DEPTH}")
            out = self._call_inner()
            # source offset of the call name: executor errors about a
            # specific call (e.g. a zero-arg Intersect()) can point at the
            # offending fragment's position in the submitted PQL
            if out.pos is None:
                out.pos = start
            return out
        finally:
            self._depth -= 1

    def _call_inner(self) -> Call:
        name = self.match(IDENT_RE)
        if name is None:
            self.error("expected call")
        handler = {
            "Set": self._set,
            "SetRowAttrs": self._set_row_attrs,
            "SetColumnAttrs": self._set_column_attrs,
            "Clear": self._clear,
            "ClearRow": self._clear_row,
            "Store": self._store,
            "TopN": self._topn,
            "Range": self._range,
        }.get(name)
        if handler is not None:
            return handler()
        return self._generic(name)

    def _open(self):
        self.expect("(")
        self.sp()

    def _close(self):
        self.expect(")")
        self.sp()

    # Set(col, field=row [, timestamp])   (pql.peg Set)
    def _set(self) -> Call:
        call = Call("Set")
        self._open()
        call.args["_col"] = self._col_or_key()
        self.comma()
        self._args_into(call)
        save = self.pos
        if self.accept_comma():
            ts = self._timestamp_opt()
            if ts is None:
                self.pos = save
                self.error("expected timestamp")
            call.args["_timestamp"] = ts
        self._close()
        return call

    def _set_row_attrs(self) -> Call:
        call = Call("SetRowAttrs")
        self._open()
        call.args["_field"] = self._posfield()
        self.comma()
        call.args["_row"] = self._col_or_key()
        self.comma()
        self._args_into(call)
        self._close()
        return call

    def _set_column_attrs(self) -> Call:
        call = Call("SetColumnAttrs")
        self._open()
        call.args["_col"] = self._col_or_key()
        self.comma()
        self._args_into(call)
        self._close()
        return call

    def _clear(self) -> Call:
        call = Call("Clear")
        self._open()
        call.args["_col"] = self._col_or_key()
        self.comma()
        self._args_into(call)
        self._close()
        return call

    def _clear_row(self) -> Call:
        call = Call("ClearRow")
        self._open()
        self._arg_into(call)
        self.sp()
        self._close()
        return call

    def _store(self) -> Call:
        call = Call("Store")
        self._open()
        call.children.append(self.call())
        self.comma()
        self._arg_into(call)
        self.sp()
        self._close()
        return call

    def _topn(self) -> Call:
        call = Call("TopN")
        self._open()
        call.args["_field"] = self._posfield()
        if self.accept_comma():
            self._allargs_into(call)
        self._close()
        return call

    # Range(timerange / conditional / arg)
    def _range(self) -> Call:
        call = Call("Range")
        self._open()
        save = self.pos
        if not self._timerange_into(call):
            self.pos = save
            if not self._conditional_into(call):
                self.pos = save
                self._arg_into(call)
                self.sp()
        self._close()
        return call

    def _generic(self, name: str) -> Call:
        call = Call(name)
        self._open()
        self._allargs_into(call)
        self.accept_comma()
        self._close()
        return call

    # allargs <- Call (comma Call)* (comma args)? / args / sp
    def _allargs_into(self, call: Call) -> None:
        self.sp()
        if self.peek() == ")":
            return
        # calls first
        while True:
            save = self.pos
            name = self.match(IDENT_RE)
            if name is not None and self.peek() == "(":
                self.pos = save
                call.children.append(self.call())
                if not self.accept_comma():
                    return
                continue
            self.pos = save
            break
        if self.peek() == ")":
            # a trailing comma before close was consumed by accept_comma
            return
        self._args_into(call)

    def _args_into(self, call: Call) -> None:
        self._arg_into(call)
        while True:
            save = self.pos
            if not self.accept_comma():
                break
            try:
                self._arg_into(call)
            except PQLError:
                # not an arg after the comma (e.g. Set's trailing timestamp):
                # leave the comma for the caller
                self.pos = save
                break
        self.sp()

    # arg <- field sp '=' sp value / field sp COND sp value
    def _arg_into(self, call: Call) -> None:
        fieldname = self._field()
        self.sp()
        # two-char ops (incl. "==") must be tried before bare "="
        for op in COND_OPS:
            if self.accept(op):
                self.sp()
                call.args[fieldname] = Condition(op, self._value())
                return
        if self.accept("="):
            self.sp()
            call.args[fieldname] = self._value()
            return
        self.error("expected '=' or condition operator")

    def _field(self) -> str:
        for r in RESERVED_FIELDS:
            if self.src.startswith(r, self.pos):
                self.pos += len(r)
                return r
        f = self.match(FIELD_RE)
        if f is None:
            self.error("expected field")
        return f

    def _posfield(self) -> str:
        f = self.match(FIELD_RE)
        if f is None:
            self.error("expected field")
        return f

    def _col_or_key(self):
        u = self.match(UINT_RE)
        if u is not None:
            return int(u)
        if self.peek() in ("'", '"'):
            return self._quoted(self.peek())
        self.error("expected column id or key")

    def _quoted(self, q: str) -> str:
        self.expect(q)
        out = []
        while True:
            if self.eof():
                self.error("unterminated string")
            ch = self.src[self.pos]
            if ch == "\\" and self.peek(2) in (f"\\{q}", "\\\\"):
                out.append(self.src[self.pos + 1])
                self.pos += 2
                continue
            if ch == q:
                self.pos += 1
                return "".join(out)
            out.append(ch)
            self.pos += 1

    # timerange <- field '=' value, timestamp, timestamp
    def _timerange_into(self, call: Call) -> bool:
        try:
            fieldname = self._field()
            self.sp()
            if not self.accept("="):
                return False
            self.sp()
            value = self._value()
            self.comma()
            start = self._timestamp_opt()
            if start is None:
                return False
            self.comma()
            end = self._timestamp_opt()
            if end is None:
                return False
        except PQLError:
            return False
        call.args[fieldname] = value
        call.args["_start"] = start
        call.args["_end"] = end
        return True

    def _timestamp_opt(self):
        save = self.pos
        q = self.peek() if self.peek() in ("'", '"') else None
        if q:
            self.pos += 1
        s = self.match(TIMESTAMP_RE)
        if s is None:
            self.pos = save
            return None
        if q and not self.accept(q):
            self.pos = save
            return None
        return datetime.strptime(s, TIME_FORMAT)

    # conditional <- condint condLT condfield condLT condint
    def _conditional_into(self, call: Call) -> bool:
        save = self.pos
        lo = self.match(INT_RE)
        if lo is None:
            return False
        self.sp()
        op1 = "<=" if self.accept("<=") else ("<" if self.accept("<") else None)
        if op1 is None:
            self.pos = save
            return False
        self.sp()
        fieldname = self.match(FIELD_RE)
        if fieldname is None:
            self.pos = save
            return False
        self.sp()
        op2 = "<=" if self.accept("<=") else ("<" if self.accept("<") else None)
        if op2 is None:
            self.pos = save
            return False
        self.sp()
        hi = self.match(INT_RE)
        if hi is None:
            self.pos = save
            return False
        self.sp()
        low = int(lo) + (1 if op1 == "<" else 0)
        high = int(hi) - (1 if op2 == "<" else 0)
        call.args[fieldname] = Condition(BETWEEN, [low, high])
        return True

    # value <- item / '[' list ']'
    def _value(self):
        if self.accept("["):
            self.sp()
            items = []
            if self.peek() != "]":
                items.append(self._item())
                while self.accept_comma():
                    items.append(self._item())
            self.sp()
            self.expect("]")
            self.sp()
            return items
        return self._item()

    def _item(self):
        # keyword literals must be followed by comma/close per grammar
        for lit, val in (("null", None), ("true", True), ("false", False)):
            if self.src.startswith(lit, self.pos):
                after = self.pos + len(lit)
                rest = self.src[after:].lstrip(" \t\n")
                if rest[:1] in (",", ")", "]", ""):
                    self.pos = after
                    return val
        # nested call
        save = self.pos
        name = self.match(IDENT_RE)
        if name is not None and self.peek() == "(":
            self.pos = save
            return self.call()
        self.pos = save
        # number (but timestamps like 2018-01-02T03:04 are bare strings)
        if TIMESTAMP_RE.match(self.src, self.pos) is None:
            n = self.match(NUM_RE)
            if n is not None:
                nxt = self.peek()
                if nxt and re.match(r"[A-Za-z\-_:]", nxt):
                    self.pos = save  # digit-leading bare string like 1a-2b
                else:
                    return float(n) if "." in n else int(n)
        if self.peek() == '"':
            return self._quoted('"')
        if self.peek() == "'":
            return self._quoted("'")
        s = self.match(BARE_STRING_RE)
        if s is not None:
            return s
        self.error("expected value")


def parse_string(src: str) -> Query:
    """Parse a PQL string into a Query (pql.ParseString, pql/parser.go:44)."""
    return _Parser(src).parse()


# One whole integer-arg Set/Clear call. Anything this doesn't cover —
# keyed ids, floats, bools, timestamps, conditions (the `==` in `f==3`
# fails the row-id group, so conditions can't be mistaken for
# assignments) — drops to the full parser.
_MUTATION_RE = re.compile(
    r"[ \t\n]*(Set|Clear)\([ \t\n]*(0|[1-9][0-9]*)[ \t\n]*,[ \t\n]*"
    r"([A-Za-z][A-Za-z0-9_-]*)[ \t\n]*=[ \t\n]*(0|[1-9][0-9]*)[ \t\n]*\)"
)


def parse_mutations_fast(src: str):
    """Linear-scan parse of an all-Set/Clear mutation envelope.

    Bulk ingest arrives as long runs of `Set(col, field=row)` calls; the
    recursive-descent parser spends ~45us per call on them, which caps a
    single core well below the streaming-ingest target before a single
    bit is written. This scanner builds the exact same AST (same Call
    name/args/pos) in one regex pass. Returns None unless the ENTIRE
    string is integer-arg Set/Clear calls — the caller then falls back
    to parse_string, so every non-trivial query keeps full-grammar
    behavior.
    """
    pos, n = 0, len(src)
    calls = []
    append = calls.append
    match = _MUTATION_RE.match
    while pos < n:
        m = match(src, pos)
        if m is None:
            if src[pos:].isspace():
                break
            return None
        name, col, field, row = m.group(1, 2, 3, 4)
        append(Call(name, {"_col": int(col), field: int(row)},
                    pos=m.start(1)))
        pos = m.end()
    if not calls:
        return None
    return Query(calls)
