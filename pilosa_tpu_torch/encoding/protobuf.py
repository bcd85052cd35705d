"""Protobuf bodies: a hand-written proto3 wire codec for the public messages.

Port of pilosa_tpu/encoding/protobuf.py (its Serializer, :157-341) that
needs no protobuf package: the messages are written and read with the
standard library and numpy, field by field, from the field numbers and
types of pilosa_tpu/proto/pilosa.proto (the reference's
internal/public.proto numbering). Content type application/x-protobuf;
the HTTP layer picks it per request (net/http_server.py).

The wire: a field is a varint tag (number << 3 | wire type) and a value;
uint64, uint32, int64 and bool are plain varints (an int64 below zero is
its two's complement in ten bytes, not zig-zag: that is sint64), double
is eight little-endian bytes, and strings, bytes and messages are
length-delimited. Repeated numbers are written packed and read packed or
not; numbers pack and unpack in numpy, so a Row of millions of columns
costs no Python loop. As in proto3, a scalar equal to its default is not
written and reads back as the default: an empty key string decodes as
"no key", which is why the executor never renders a key as "".

Covered: QueryRequest, QueryResponse, QueryResult (Row, Pair, ValCount,
RowIdentifiers, GroupCount, FieldRow), ColumnAttrSet, Attr,
ImportRequest, ImportValueRequest and ImportRoaringRequest. The cluster's
messages (QueryBatch*, TranslateKeys*) wait for the port's cluster.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Optional

import numpy as np

from pilosa_tpu_torch.executor import (
    GroupCounts,
    Pairs,
    RowIdentifiers,
    ValCount,
)
from pilosa_tpu_torch.models.row import Row

CONTENT_TYPE = "application/x-protobuf"

# QueryResult.Type (the reference's queryResultType order)
RESULT_NIL = 0
RESULT_ROW = 1
RESULT_PAIRS = 2
RESULT_VALCOUNT = 3
RESULT_UINT64 = 4
RESULT_BOOL = 5
RESULT_ROWIDS = 6
RESULT_GROUPCOUNTS = 7
RESULT_ROWIDENTIFIERS = 8

# Attr.Type
ATTR_STRING = 1
ATTR_INT = 2
ATTR_BOOL = 3
ATTR_FLOAT = 4

_MASK64 = (1 << 64) - 1
_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5
_NUMERIC = ("uint64", "int64", "bool", "double")

# -- message schemas: field number -> (name, kind, repeated); a kind that is
#    a dict is a nested message -------------------------------------------

ATTR = {1: ("Key", "string", False), 2: ("Type", "uint64", False),
        3: ("StringValue", "string", False), 4: ("IntValue", "int64", False),
        5: ("BoolValue", "bool", False), 6: ("FloatValue", "double", False)}
ROW = {1: ("Columns", "uint64", True), 2: ("Attrs", ATTR, True),
       3: ("Keys", "string", True)}
ROW_IDENTIFIERS = {1: ("Rows", "uint64", True), 2: ("Keys", "string", True)}
PAIR = {1: ("ID", "uint64", False), 2: ("Count", "uint64", False),
        3: ("Key", "string", False)}
FIELD_ROW = {1: ("Field", "string", False), 2: ("RowID", "uint64", False),
             3: ("RowKey", "string", False)}
GROUP_COUNT = {1: ("Group", FIELD_ROW, True), 2: ("Count", "uint64", False)}
VAL_COUNT = {1: ("Val", "int64", False), 2: ("Count", "int64", False)}
COLUMN_ATTR_SET = {1: ("ID", "uint64", False), 2: ("Attrs", ATTR, True),
                   3: ("Key", "string", False)}
QUERY_REQUEST = {1: ("Query", "string", False), 2: ("Shards", "uint64", True),
                 3: ("ColumnAttrs", "bool", False),
                 5: ("Remote", "bool", False),
                 6: ("ExcludeRowAttrs", "bool", False),
                 7: ("ExcludeColumns", "bool", False),
                 8: ("Profile", "bool", False)}
QUERY_RESULT = {1: ("Row", ROW, False), 2: ("N", "uint64", False),
                3: ("Pairs", PAIR, True), 4: ("Changed", "bool", False),
                5: ("ValCount", VAL_COUNT, False), 6: ("Type", "uint64", False),
                7: ("RowIDs", "uint64", True),
                8: ("GroupCounts", GROUP_COUNT, True),
                9: ("RowIdentifiers", ROW_IDENTIFIERS, False)}
QUERY_RESPONSE = {1: ("Err", "string", False),
                  2: ("Results", QUERY_RESULT, True),
                  3: ("ColumnAttrSets", COLUMN_ATTR_SET, True),
                  4: ("Profile", "bytes", False)}
IMPORT_REQUEST = {1: ("Index", "string", False), 2: ("Field", "string", False),
                  3: ("Shard", "uint64", False),
                  4: ("RowIDs", "uint64", True),
                  5: ("ColumnIDs", "uint64", True),
                  6: ("Timestamps", "int64", True),
                  7: ("RowKeys", "string", True),
                  8: ("ColumnKeys", "string", True)}
IMPORT_VALUE_REQUEST = {1: ("Index", "string", False),
                        2: ("Field", "string", False),
                        3: ("Shard", "uint64", False),
                        5: ("ColumnIDs", "uint64", True),
                        6: ("Values", "int64", True),
                        7: ("ColumnKeys", "string", True)}
IMPORT_ROARING_VIEW = {1: ("Name", "string", False), 2: ("Data", "bytes", False)}
IMPORT_ROARING_REQUEST = {1: ("Clear", "bool", False),
                          2: ("views", IMPORT_ROARING_VIEW, True)}


# -- varints -----------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= _MASK64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            return n & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")


def pack_varints(values) -> bytes:
    """Varints of an integer array (int64 as two's complement), in numpy."""
    v = np.asarray(values)
    if v.size == 0:
        return b""
    v = v.astype(np.int64).view(np.uint64) if v.dtype.kind == "i" \
        else v.astype(np.uint64)
    v = v.reshape(-1)
    lens = np.ones(v.size, dtype=np.int64)
    t = v >> np.uint64(7)
    while True:
        more = t > 0
        if not more.any():
            break
        lens += more
        t >>= np.uint64(7)
    starts = np.cumsum(lens) - lens
    out = np.empty(int(starts[-1] + lens[-1]), dtype=np.uint8)
    t = v.copy()
    for k in range(int(lens.max())):
        sel = np.nonzero(lens > k)[0]
        b = (t[sel] & np.uint64(0x7F)).astype(np.uint8)
        b |= np.where(lens[sel] > k + 1, 0x80, 0).astype(np.uint8)
        out[starts[sel] + k] = b
        t >>= np.uint64(7)
    return out.tobytes()


def unpack_varints(buf: bytes) -> np.ndarray:
    """uint64 array of a packed run of varints, in numpy."""
    b = np.frombuffer(buf, dtype=np.uint8)
    if b.size == 0:
        return np.empty(0, dtype=np.uint64)
    ends = np.nonzero(b < 0x80)[0]
    if ends.size == 0 or ends[-1] != b.size - 1:
        raise ValueError("truncated packed varints")
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    if lens.max() > 10:
        raise ValueError("varint longer than ten bytes")
    out = np.zeros(ends.size, dtype=np.uint64)
    for k in range(int(lens.max())):
        sel = np.nonzero(lens > k)[0]
        out[sel] |= ((b[starts[sel] + k] & 0x7F).astype(np.uint64)
                     << np.uint64(7 * k))
    return out


# -- messages ----------------------------------------------------------------


def _default(kind):
    if isinstance(kind, dict):
        return None
    return {"uint64": 0, "int64": 0, "bool": False, "double": 0.0,
            "string": "", "bytes": b""}[kind]


def _key(num: int, wt: int) -> bytes:
    return _varint(num << 3 | wt)


def _scalar(kind: str, num: int, v) -> bytes:
    if kind == "double":
        return _key(num, _WT_I64) + struct.pack("<d", float(v))
    if kind in ("string", "bytes"):
        data = v.encode() if kind == "string" else bytes(v)
        return _key(num, _WT_LEN) + _varint(len(data)) + data
    return _key(num, _WT_VARINT) + _varint(int(v))


def encode(schema: dict, msg: dict) -> bytes:
    """One message from a dict of its field names (missing: default)."""
    out = []
    for num in sorted(schema):
        name, kind, repeated = schema[num]
        v = msg.get(name)
        if v is None:
            continue
        if isinstance(kind, dict):
            for m in (v if repeated else [v]):
                data = encode(kind, m)
                out.append(_key(num, _WT_LEN) + _varint(len(data)) + data)
        elif repeated and kind in _NUMERIC:
            if len(v) == 0:
                continue
            if kind == "double":
                data = np.asarray(v, dtype="<f8").tobytes()
            else:
                data = pack_varints(np.asarray(
                    v, dtype=np.int64 if kind == "int64" else np.uint64))
            out.append(_key(num, _WT_LEN) + _varint(len(data)) + data)
        elif repeated:
            out.extend(_scalar(kind, num, x) for x in v)
        elif v != _default(kind) or (kind == "double"
                                     and math.copysign(1.0, v) < 0):
            out.append(_scalar(kind, num, v))
    return b"".join(out)


def _as_int64(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


def _numeric(kind: str, raw: int):
    if kind == "int64":
        return _as_int64(raw)
    if kind == "bool":
        return raw != 0
    return raw


def decode(schema: dict, buf: bytes) -> dict:
    """A dict of every field of the schema (absent: its default; repeated
    numbers as numpy arrays). Unknown fields are skipped."""
    out = {}
    for num, (name, kind, repeated) in schema.items():
        if repeated:
            out[name] = [] if (isinstance(kind, dict)
                               or kind not in _NUMERIC) else None
        else:
            out[name] = _default(kind)
    parts: dict = {}  # repeated numbers: chunks to concatenate
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        num, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            raw, pos = _read_varint(buf, pos)
            val = ("varint", raw)
        elif wt == _WT_I64:
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            val = ("i64", buf[pos:pos + 8])
            pos += 8
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            val = ("len", buf[pos:pos + ln])
            pos += ln
        elif wt == _WT_I32:
            pos += 4
            continue
        else:
            raise ValueError(f"unsupported wire type {wt}")
        spec = schema.get(num)
        if spec is None:
            continue
        name, kind, repeated = spec
        form, raw = val
        if isinstance(kind, dict):
            if form != "len":
                raise ValueError(f"field {name}: expected a message")
            m = decode(kind, raw)
            if repeated:
                out[name].append(m)
            else:
                out[name] = m
        elif kind in _NUMERIC:
            if kind == "double":
                if form == "len":
                    arr = np.frombuffer(raw, dtype="<f8").astype(np.float64)
                elif form == "i64":
                    arr = np.array([struct.unpack("<d", raw)[0]])
                else:
                    raise ValueError(f"field {name}: expected a double")
            elif form == "len":
                arr = unpack_varints(raw)
            elif form == "varint":
                arr = np.array([raw], dtype=np.uint64)
            else:
                raise ValueError(f"field {name}: expected a varint")
            if repeated:
                parts.setdefault(name, []).append(arr)
            else:
                v = arr[-1].item()
                out[name] = v if kind == "double" else _numeric(kind, int(v))
        else:
            if form != "len":
                raise ValueError(f"field {name}: expected bytes")
            v = raw.decode() if kind == "string" else bytes(raw)
            if repeated:
                out[name].append(v)
            else:
                out[name] = v
    for num, (name, kind, repeated) in schema.items():
        if repeated and not isinstance(kind, dict) and kind in _NUMERIC:
            chunks = parts.get(name)
            if kind == "double":
                arr = (np.concatenate(chunks) if chunks
                       else np.empty(0, dtype=np.float64))
            else:
                arr = (np.concatenate(chunks) if chunks
                       else np.empty(0, dtype=np.uint64))
                if kind == "int64":
                    arr = arr.view(np.int64)
                elif kind == "bool":
                    arr = arr != 0
            out[name] = arr
    return out


# -- results -----------------------------------------------------------------


def _encode_attrs(attrs: dict) -> list:
    out = []
    for key in sorted(attrs):
        val = attrs[key]
        if isinstance(val, bool):
            out.append({"Key": key, "Type": ATTR_BOOL, "BoolValue": val})
        elif isinstance(val, int):
            out.append({"Key": key, "Type": ATTR_INT, "IntValue": val})
        elif isinstance(val, float):
            out.append({"Key": key, "Type": ATTR_FLOAT, "FloatValue": val})
        else:
            out.append({"Key": key, "Type": ATTR_STRING,
                        "StringValue": str(val)})
    return out


def _decode_attrs(attrs: list) -> dict:
    out = {}
    for a in attrs:
        t = a["Type"]
        if t == ATTR_BOOL:
            out[a["Key"]] = a["BoolValue"]
        elif t == ATTR_INT:
            out[a["Key"]] = a["IntValue"]
        elif t == ATTR_FLOAT:
            out[a["Key"]] = a["FloatValue"]
        else:
            out[a["Key"]] = a["StringValue"]
    return out


def _encode_result(result) -> dict:
    if isinstance(result, Row):
        return {"Type": RESULT_ROW, "Row": {
            "Columns": result.columns(), "Keys": list(result.keys),
            "Attrs": _encode_attrs(result.attrs)}}
    if isinstance(result, Pairs):
        keys = result.row_keys
        if keys is not None:
            pairs = [{"ID": int(i), "Count": int(c), "Key": k}
                     for (i, c), k in zip(result, keys)]
        else:
            pairs = [{"ID": int(i), "Count": int(c)} for i, c in result]
        return {"Type": RESULT_PAIRS, "Pairs": pairs}
    if isinstance(result, ValCount):
        return {"Type": RESULT_VALCOUNT,
                "ValCount": {"Val": int(result.val),
                             "Count": int(result.count)}}
    if isinstance(result, RowIdentifiers):
        if result.row_keys is not None:
            ri = {"Keys": list(result.row_keys)}
        else:
            ri = {"Rows": [int(x) for x in result]}
        return {"Type": RESULT_ROWIDENTIFIERS, "RowIdentifiers": ri}
    if isinstance(result, GroupCounts):
        groups = []
        for gc in result:
            groups.append({"Count": int(gc["count"]), "Group": [
                {"Field": fr["field"], "RowKey": fr["rowKey"]}
                if "rowKey" in fr else
                {"Field": fr["field"], "RowID": int(fr["rowID"])}
                for fr in gc["group"]]})
        return {"Type": RESULT_GROUPCOUNTS, "GroupCounts": groups}
    if isinstance(result, bool):
        return {"Type": RESULT_BOOL, "Changed": result}
    if isinstance(result, (int, np.integer)):
        return {"Type": RESULT_UINT64, "N": int(result)}
    if result is None:
        return {"Type": RESULT_NIL}
    raise TypeError(f"unserializable result type: {type(result)!r}")


def decode_result(r: dict):
    """A decoded QueryResult -> the executor's value (the mirror of
    _encode_result)."""
    t = r["Type"]
    if t == RESULT_ROW:
        m = r["Row"] or decode(ROW, b"")
        row = Row.from_columns(m["Columns"])
        row.attrs = _decode_attrs(m["Attrs"])
        row.keys = list(m["Keys"])
        return row
    if t == RESULT_PAIRS:
        pairs = Pairs((p["ID"], p["Count"]) for p in r["Pairs"])
        if any(p["Key"] for p in r["Pairs"]):
            pairs.row_keys = [p["Key"] for p in r["Pairs"]]
        return pairs
    if t == RESULT_VALCOUNT:
        vc = r["ValCount"] or decode(VAL_COUNT, b"")
        return ValCount(vc["Val"], vc["Count"])
    if t == RESULT_UINT64:
        return int(r["N"])
    if t == RESULT_BOOL:
        return bool(r["Changed"])
    if t == RESULT_ROWIDENTIFIERS:
        ri = r["RowIdentifiers"] or decode(ROW_IDENTIFIERS, b"")
        if ri["Keys"]:
            out = RowIdentifiers()
            out.row_keys = list(ri["Keys"])
            return out
        return RowIdentifiers(int(x) for x in ri["Rows"])
    if t == RESULT_GROUPCOUNTS:
        return GroupCounts(
            {"group": [{"field": fr["Field"], "rowKey": fr["RowKey"]}
                       if fr["RowKey"] else
                       {"field": fr["Field"], "rowID": fr["RowID"]}
                       for fr in g["Group"]],
             "count": g["Count"]}
            for g in r["GroupCounts"])
    return None


def _list_or_none(arr) -> Optional[list]:
    return arr.tolist() if len(arr) else None


class Serializer:
    """The wire messages of the public HTTP surface, with the JAX
    Serializer's method names and dict shapes."""

    content_type = CONTENT_TYPE

    # -- query ---------------------------------------------------------------

    def encode_query_request(self, pql: str, shards=None,
                             remote: bool = False, column_attrs: bool = False,
                             profile: bool = False) -> bytes:
        return encode(QUERY_REQUEST, {
            "Query": pql, "Shards": list(shards or []), "Remote": remote,
            "ColumnAttrs": column_attrs, "Profile": profile})

    def decode_query_request(self, data: bytes) -> dict:
        m = decode(QUERY_REQUEST, data)
        return {"query": m["Query"], "shards": _list_or_none(m["Shards"]),
                "remote": m["Remote"], "columnAttrs": m["ColumnAttrs"],
                "excludeRowAttrs": m["ExcludeRowAttrs"],
                "excludeColumns": m["ExcludeColumns"],
                "profile": m["Profile"]}

    def encode_query_response(self, results: list, err: str = "",
                              column_attr_sets=None,
                              profile: Optional[dict] = None) -> bytes:
        msg = {"Err": err,
               "Results": [_encode_result(r) for r in results],
               "ColumnAttrSets": [
                   {"ID": int(c["id"]), "Key": c.get("key", ""),
                    "Attrs": _encode_attrs(c.get("attrs", {}))}
                   for c in column_attr_sets or []]}
        if profile is not None:
            msg["Profile"] = json.dumps(profile).encode()
        return encode(QUERY_RESPONSE, msg)

    def decode_query_response(self, data: bytes) -> dict:
        m = decode(QUERY_RESPONSE, data)
        profile = None
        if m["Profile"]:
            try:
                profile = json.loads(m["Profile"])
            except ValueError:
                profile = None
        return {"err": m["Err"],
                "results": [decode_result(r) for r in m["Results"]],
                "profile": profile,
                "columnAttrSets": [
                    {"id": c["ID"], "attrs": _decode_attrs(c["Attrs"]),
                     **({"key": c["Key"]} if c["Key"] else {})}
                    for c in m["ColumnAttrSets"]]}

    # -- imports -------------------------------------------------------------

    def encode_import_request(self, index: str, field: str, shard: int = 0,
                              row_ids=None, column_ids=None, timestamps=None,
                              row_keys=None, column_keys=None) -> bytes:
        return encode(IMPORT_REQUEST, {
            "Index": index, "Field": field, "Shard": shard,
            "RowIDs": [] if row_ids is None else row_ids,
            "ColumnIDs": [] if column_ids is None else column_ids,
            "Timestamps": [] if timestamps is None else timestamps,
            "RowKeys": list(row_keys or []),
            "ColumnKeys": list(column_keys or [])})

    def decode_import_request(self, data: bytes) -> dict:
        m = decode(IMPORT_REQUEST, data)
        return {"index": m["Index"], "field": m["Field"], "shard": m["Shard"],
                "rowIDs": _list_or_none(m["RowIDs"]),
                "columnIDs": _list_or_none(m["ColumnIDs"]),
                "timestamps": _list_or_none(m["Timestamps"]),
                "rowKeys": m["RowKeys"] or None,
                "columnKeys": m["ColumnKeys"] or None}

    def encode_import_value_request(self, index: str, field: str,
                                    shard: int = 0, column_ids=None,
                                    values=None, column_keys=None) -> bytes:
        return encode(IMPORT_VALUE_REQUEST, {
            "Index": index, "Field": field, "Shard": shard,
            "ColumnIDs": [] if column_ids is None else column_ids,
            "Values": [] if values is None else values,
            "ColumnKeys": list(column_keys or [])})

    def decode_import_value_request(self, data: bytes) -> dict:
        m = decode(IMPORT_VALUE_REQUEST, data)
        return {"index": m["Index"], "field": m["Field"], "shard": m["Shard"],
                "columnIDs": _list_or_none(m["ColumnIDs"]),
                "values": _list_or_none(m["Values"]),
                "columnKeys": m["ColumnKeys"] or None}

    def encode_import_roaring_request(self, views: dict,
                                      clear: bool = False) -> bytes:
        return encode(IMPORT_ROARING_REQUEST, {
            "Clear": clear,
            "views": [{"Name": name, "Data": data}
                      for name, data in views.items()]})

    def decode_import_roaring_request(self, data: bytes) -> dict:
        m = decode(IMPORT_ROARING_REQUEST, data)
        return {"clear": m["Clear"],
                "views": {v["Name"]: v["Data"] for v in m["views"]}}
