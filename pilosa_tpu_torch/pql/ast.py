"""PQL AST: Query / Call / Condition (reference: pql/ast.go:27,247,451).

Copied whole from pilosa_tpu/pql/ast.py (pure Python).
"""

from __future__ import annotations

from typing import Any, Optional

# Condition ops (reference: pql/token.go)
ASSIGN, EQ, NEQ, LT, LTE, GT, GTE, BETWEEN = "=", "==", "!=", "<", "<=", ">", ">=", "><"


class Condition:
    __slots__ = ("op", "value")

    def __init__(self, op: str, value: Any):
        self.op = op
        self.value = value

    def int_slice_value(self) -> list[int]:
        """cond.Value as ints (Condition.IntSliceValue, pql/ast.go:464)."""
        if not isinstance(self.value, (list, tuple)):
            raise ValueError(f"unexpected type {type(self.value).__name__} in IntSliceValue")
        out = []
        for v in self.value:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"unexpected value type in IntSliceValue: {v!r}")
            out.append(v)
        return out

    def __eq__(self, other):
        return isinstance(other, Condition) and (self.op, self.value) == (other.op, other.value)

    def __repr__(self):
        return f"Condition({self.op!r}, {self.value!r})"


class Call:
    __slots__ = ("name", "args", "children", "pos")

    def __init__(self, name: str, args: Optional[dict] = None,
                 children: Optional[list["Call"]] = None,
                 pos: Optional[int] = None):
        self.name = name
        self.args = args or {}
        self.children = children or []
        # character offset of the call name in the source PQL (set by the
        # parser; None for programmatically-built calls). Diagnostic only:
        # excluded from __eq__ so rewritten/planned trees still compare
        # equal to hand-built expectations.
        self.pos = pos

    # -- typed arg getters (pql/ast.go:269-360) -----------------------------

    def field_arg(self) -> str:
        """The single field=row argument of write calls (FieldArg,
        pql/ast.go:256)."""
        for k, v in self.args.items():
            if not k.startswith("_") and not isinstance(v, Condition):
                return k
        raise ValueError(f"{self.name} expects a field argument")

    def uint_arg(self, key: str):
        v = self.args.get(key)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise ValueError(f"arg {key!r} must be a non-negative integer, got {v!r}")
        return v

    def int_arg(self, key: str):
        v = self.args.get(key)
        if v is None:
            return None
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"arg {key!r} must be an integer, got {v!r}")
        return v

    def bool_arg(self, key: str):
        v = self.args.get(key)
        if v is None:
            return None
        if not isinstance(v, bool):
            raise ValueError(f"arg {key!r} must be a bool, got {v!r}")
        return v

    def string_arg(self, key: str):
        v = self.args.get(key)
        if v is None:
            return None
        if not isinstance(v, str):
            raise ValueError(f"arg {key!r} must be a string, got {v!r}")
        return v

    def uint_slice_arg(self, key: str):
        v = self.args.get(key)
        if v is None:
            return None
        if isinstance(v, int) and not isinstance(v, bool):
            return [v]
        if isinstance(v, list) and all(isinstance(x, int) and not isinstance(x, bool) for x in v):
            return list(v)
        raise ValueError(f"arg {key!r} must be a list of integers, got {v!r}")

    def __eq__(self, other):
        return (isinstance(other, Call)
                and (self.name, self.args, self.children)
                == (other.name, other.args, other.children))

    def __repr__(self):
        parts = [repr(c) for c in self.children]
        parts += [f"{k}={v!r}" for k, v in self.args.items()]
        return f"{self.name}({', '.join(parts)})"

    # -- PQL serialization (Call.String, pql/ast.go:231; used by remote
    #    fan-out, which re-sends the PQL string — executor.go:2147) ---------

    def to_pql(self) -> str:
        args = dict(self.args)
        head: list[str] = []
        tail: list[str] = []
        if self.name in ("Set", "Clear", "SetColumnAttrs"):
            head.append(_fmt_value(args.pop("_col")))
        if self.name in ("SetRowAttrs", "TopN"):
            head.append(str(args.pop("_field")))
        if self.name == "SetRowAttrs":
            head.append(_fmt_value(args.pop("_row")))
        ts = args.pop("_timestamp", None)
        start = args.pop("_start", None)
        end = args.pop("_end", None)
        head.extend(c.to_pql() for c in self.children)
        for k, v in args.items():
            if isinstance(v, Condition):
                tail.append(f"{k} {v.op} {_fmt_value(v.value)}")
            else:
                tail.append(f"{k}={_fmt_value(v)}")
        if start is not None:
            tail.append(_fmt_timestamp(start))
        if end is not None:
            tail.append(_fmt_timestamp(end))
        if ts is not None:
            tail.append(_fmt_timestamp(ts))
        return f"{self.name}({', '.join(head + tail)})"


def _fmt_value(v) -> str:
    import json as _json
    from datetime import datetime as _dt
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        return _json.dumps(v)
    if isinstance(v, _dt):
        return v.strftime("%Y-%m-%dT%H:%M")
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    if isinstance(v, Call):
        return v.to_pql()
    return str(v)


def _fmt_timestamp(v) -> str:
    from datetime import datetime as _dt
    return v.strftime("%Y-%m-%dT%H:%M") if isinstance(v, _dt) else str(v)


class Query:
    __slots__ = ("calls",)

    def __init__(self, calls: Optional[list[Call]] = None):
        self.calls = calls or []

    def write_call_count(self) -> int:
        """Number of mutating calls (WriteCallN, pql/ast.go:219)."""
        writes = {"Set", "Clear", "ClearRow", "Store", "SetRowAttrs", "SetColumnAttrs"}
        return sum(1 for c in self.calls if c.name in writes)

    def __repr__(self):
        return f"Query({self.calls!r})"
