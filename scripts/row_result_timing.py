"""Time Row results whose root is sparse, served over HTTP on the card.

    python3 scripts/row_result_timing.py [--shards 1024] [--reads 10]

Serves one index with the server's defaults: one dense row of f (8.5k-40k
bits a shard, as chip_smoke.py's Count path) and the sparse rows of s
(chip_smoke.py's hybrid rows, K = 8..4096 a shard). Then it reads
Intersect(Row(s=a), Row(f=0)) for three rows a of s: a first read, then
--reads more, every answer checked against numpy. It prints one JSON
line: per query the first read's ms, the p50 and p99 of the rest, the
result's columns, and the server's plan cache: "on", "off", or "none"
where its executor has none (a package from before the cache, or
PILOSA_TPU_TORCH_PLAN_CACHE=0).

pilosa_tpu_torch is imported from the path as it stands, so the script
times another checkout of the package when PYTHONPATH points at it; the
data helpers always come from this checkout's chip_smoke.py.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))  # after PYTHONPATH: another checkout comes first
S_ROWS = (0, 5, 9)  # K = 8, 256, 4096 bits a shard


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", type=int, default=1024)
    ap.add_argument("--reads", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("row_result_timing: no CUDA card", file=sys.stderr)
        return 2
    import pilosa_tpu_torch
    from pilosa_tpu_torch.server import Server

    cs = _smoke()
    f0 = cs.make_rows(1, args.shards, args.seed)[0]
    s_rows, _ = cs.make_hybrid_rows(args.shards, args.seed)
    packed = cs.packed_row(f0, args.shards)
    out = {"package": str(Path(pilosa_tpu_torch.__file__).parent),
           "shards": args.shards, "queries": []}
    with tempfile.TemporaryDirectory(prefix="row_result_timing_") as tmp:
        srv = Server(os.path.join(tmp, "data"), port=0,
                     device=args.device).open()
        port = srv.http.port
        try:
            pc = getattr(srv.executor, "plan_cache", None)
            out["plan_cache"] = ("none" if pc is None else
                                 "on" if pc.enabled else "off")
            cs._http(port, "POST", "/index/i", b"{}")
            for name in ("f", "s"):
                cs._http(port, "POST", f"/index/i/field/{name}", b"{}")
            srv.api.import_bits("i", "f", *cs.shard_major([f0], args.shards))
            srv.api.import_bits("i", "s",
                                *cs.shard_major(s_rows, args.shards))
            for a in S_ROWS:
                pql = f"Intersect(Row(s={a}), Row(f=0))"
                want = s_rows[a][cs._bit_test(packed, s_rows[a])].tolist()
                lat = []
                for _ in range(args.reads + 1):
                    t = time.perf_counter()
                    got = cs._http(port, "POST", "/index/i/query",
                                   pql.encode())["results"][0]["columns"]
                    lat.append((time.perf_counter() - t) * 1e3)
                    if got != want:
                        raise AssertionError(f"{pql}: {len(got)} columns, "
                                             f"numpy {len(want)}")
                out["queries"].append({
                    "pql": pql, "columns": len(want),
                    "first_ms": lat[0],
                    "p50_ms": statistics.median(lat[1:]),
                    "p99_ms": float(np.percentile(lat[1:], 99))})
                print(json.dumps(out["queries"][-1]), file=sys.stderr,
                      flush=True)
        finally:
            srv.close()
    if args.device == "cuda":
        print(cs.smi("name,power.limit"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
