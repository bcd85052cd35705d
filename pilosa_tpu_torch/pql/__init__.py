"""PQL: the Pilosa query language (copy of pilosa_tpu/pql/__init__.py)."""

import functools

from pilosa_tpu_torch.pql.ast import Call, Condition, Query  # noqa: F401
from pilosa_tpu_torch.pql.parser import PQLError, parse_string  # noqa: F401


@functools.lru_cache(maxsize=1024)
def parse_string_cached(pql: str):
    """parse_string with an LRU: serving workloads repeat query strings,
    and the executor treats the AST as read-only."""
    return parse_string(pql)
