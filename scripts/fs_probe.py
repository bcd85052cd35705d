#!/usr/bin/env python3
"""Measure what a fragment write costs on this host's file system.

    python3 scripts/fs_probe.py [--files N] [--dir DIR]

Prints the open-file limit (RLIMIT_NOFILE), the file system under DIR
(default: the temporary directory), and the wall time of N small
snapshot-style writes (write a temp file, fsync, rename over the target)
and of N append-opens (open for append, write 100 bytes, close), each
with 1, 8, 32 and 64 threads. A bulk import writes one snapshot per
fragment it touches and a WAL append opens the fragment's file when it
keeps no descriptor, so these bound the port's import and write paths
on a host whose file system serializes such calls.
"""

from __future__ import annotations

import argparse
import os
import resource
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor


def snapshot_write(path: str) -> None:
    with open(path + ".tmp", "wb") as f:
        f.write(b"x" * 2000)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)


def append_open(path: str) -> None:
    with open(path, "ab") as f:
        f.write(b"y" * 100)


def timed(fn, paths: list, threads: int) -> float:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(fn, paths))
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--files", type=int, default=4000)
    ap.add_argument("--dir", default=tempfile.gettempdir())
    args = ap.parse_args()
    print("RLIMIT_NOFILE (soft, hard):",
          resource.getrlimit(resource.RLIMIT_NOFILE))
    print(subprocess.run(["df", "-hT", args.dir], capture_output=True,
                         text=True).stdout.strip())
    for threads in (1, 8, 32, 64):
        with tempfile.TemporaryDirectory(dir=args.dir) as d:
            paths = [os.path.join(d, str(i)) for i in range(args.files)]
            snap = timed(snapshot_write, paths, threads)
            app = timed(append_open, paths, threads)
        print(f"threads {threads}: {args.files} snapshot writes "
              f"{snap:.2f} s ({snap / args.files * 1e3:.3f} ms each); "
              f"{args.files} append-opens {app:.2f} s "
              f"({app / args.files * 1e3:.3f} ms each)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
