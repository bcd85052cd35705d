"""URI: scheme/host/port triple for node addresses.

Copy of pilosa_tpu/net/uri.py (the reference's uri.go): default
`http://localhost:10101`, accepts partial forms ("host", ":port",
"scheme://host", "host:port"), validates scheme and port, normalizes to
a string. The CLI reads `bind` and the `[cluster] hosts` with it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

DEFAULT_SCHEME = "http"
DEFAULT_HOST = "localhost"
DEFAULT_PORT = 10101

_URI_RE = re.compile(
    r"^(?:(?P<scheme>[a-zA-Z][a-zA-Z0-9+.-]*)://)?"
    r"(?P<host>\[[0-9a-fA-F:]+\]|[0-9a-zA-Z._-]*)"
    r"(?::(?P<port>\d+))?$"
)


class URIError(ValueError):
    pass


@dataclass(frozen=True)
class URI:
    scheme: str = DEFAULT_SCHEME
    host: str = DEFAULT_HOST
    port: int = DEFAULT_PORT

    @classmethod
    def parse(cls, address: str) -> "URI":
        """Parse a full or partial address, filling defaults (uri.go
        NewURIFromAddress semantics)."""
        address = (address or "").strip()
        m = _URI_RE.match(address)
        if m is None:
            raise URIError(f"invalid address: {address!r}")
        scheme = m.group("scheme") or DEFAULT_SCHEME
        if scheme not in ("http", "https"):
            raise URIError(f"invalid scheme: {scheme!r}")
        host = m.group("host") or DEFAULT_HOST
        port = int(m.group("port")) if m.group("port") else DEFAULT_PORT
        if not (0 < port < 65536):
            raise URIError(f"invalid port: {port}")
        return cls(scheme, host, port)

    @property
    def host_port(self) -> str:
        return f"{self.host}:{self.port}"

    def normalize(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def __str__(self) -> str:
        return self.normalize()
