"""Server: holder + executor + API + HTTP, mirroring pilosa_tpu.server.

    srv = Server(data_dir, port=0, device="cuda").open()
    ... POST srv.uri + "/index/i/query" ...
    srv.close()

A single node on one device: no cluster, gossip, QoS or telemetry.

sparse_threshold and run_threshold are the JAX server's [query]
sparse-threshold and run-threshold (pilosa_tpu/server.py:245-260): rows
with at most sparse_threshold bits in every shard load as sparse leaves,
rows above it with at most run_threshold intervals as run leaves; 0
disables a form.
"""

from __future__ import annotations

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.net.http_server import Handler, HTTPServer
from pilosa_tpu_torch.parallel.residency import (
    DEFAULT_RUN_THRESHOLD,
    DEFAULT_SPARSE_THRESHOLD,
)
from pilosa_tpu_torch.state import open_holder


class Server:
    def __init__(self, data_dir: str, host: str = "localhost", port: int = 0,
                 device="cuda",
                 sparse_threshold: int = DEFAULT_SPARSE_THRESHOLD,
                 run_threshold: int = DEFAULT_RUN_THRESHOLD):
        for name, value in (("sparse-threshold", sparse_threshold),
                            ("run-threshold", run_threshold)):
            if value < 0:
                raise ValueError(f"invalid [query] {name} {value!r} "
                                 "(expected >= 0)")
        self.data_dir = data_dir
        self.host = host
        self.port = port
        self.device = device
        self.sparse_threshold = sparse_threshold
        self.run_threshold = run_threshold
        self.holder = None
        self.executor = None
        self.api = None
        self.http = None

    def open(self) -> "Server":
        self.holder = open_holder(self.data_dir)
        self.executor = Executor(self.holder, device=self.device)
        self.executor.hybrid.threshold = self.sparse_threshold
        self.executor.hybrid.run_threshold = self.run_threshold
        self.api = API(self.holder, self.executor)
        self.http = HTTPServer(Handler(self.api), self.host, self.port)
        self.api.uri = self.http.uri
        self.http.serve_background()
        return self

    @property
    def uri(self) -> str:
        return self.http.uri

    def close(self) -> None:
        if self.http is not None:
            self.http.close()
            self.http = None
        if self.holder is not None:
            self.holder.close()
