#!/usr/bin/env python3
"""Measure what a fragment write costs on this host's file system.

    python3 scripts/fs_probe.py [--files N] [--dir DIR] [--sqlite-only]

Prints the open-file limit (RLIMIT_NOFILE), the file system under DIR
(default: the temporary directory), and the wall time of N small
snapshot-style writes (write a temp file, fsync, rename over the target)
and of N append-opens (open for append, write 100 bytes, close), each
with 1, 8, 32 and 64 threads. A bulk import writes one snapshot per
fragment it touches and a WAL append opens the fragment's file when it
keeps no descriptor, so these bound the port's import and write paths
on a host whose file system serializes such calls.

The sqlite probe opens a database in DIR under each journal setting the
translate index and the attribute stores could use (WAL, WAL with
locking_mode=EXCLUSIVE, the default rollback journal), reports the mode
sqlite actually granted, times 1,000 one-row commits and one commit of
1,000 rows, then reopens the file and counts the rows back. A mode the
file system refuses (WAL's shared-memory index needs mmap) fails here
rather than in a server. Then, as the translate index works: 1,000,000
keys inserted into a WAL table with a reverse index, all of them looked
up in IN queries of 900, and 20,000 single lookups, with sqlite's
default page cache, with 256 MiB, and with 256 MiB under
locking_mode=EXCLUSIVE (no shared-memory locking per statement).
"""

from __future__ import annotations

import argparse
import os
import resource
import sqlite3
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


SQLITE_MODES = (
    ("wal", ("PRAGMA journal_mode=WAL", "PRAGMA synchronous=OFF")),
    ("wal+exclusive", ("PRAGMA locking_mode=EXCLUSIVE",
                       "PRAGMA journal_mode=WAL", "PRAGMA synchronous=OFF")),
    ("rollback", ()),
)


def sqlite_probe(d: str, name: str, pragmas: tuple, n: int = 1000) -> str:
    path = os.path.join(d, name + ".db")
    try:
        db = sqlite3.connect(path)
        for p in pragmas:
            db.execute(p)
        mode = db.execute("PRAGMA journal_mode").fetchone()[0]
        db.execute("CREATE TABLE kv (k INTEGER PRIMARY KEY, v TEXT)")
        db.commit()
        t0 = time.perf_counter()
        for i in range(n):
            db.execute("INSERT INTO kv VALUES (?, ?)", (i, "x" * 40))
            db.commit()
        each = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.executemany("INSERT INTO kv VALUES (?, ?)",
                       ((n + i, "y" * 40) for i in range(n)))
        db.commit()
        one = time.perf_counter() - t0
        db.close()
        t0 = time.perf_counter()
        db = sqlite3.connect(path)
        for p in pragmas:
            db.execute(p)
        rows = db.execute("SELECT COUNT(*) FROM kv").fetchone()[0]
        db.close()
        reopen = time.perf_counter() - t0
    except sqlite3.Error as e:
        return f"sqlite {name}: FAILED ({type(e).__name__}: {e})"
    ok = "ok" if rows == 2 * n else f"LOST ROWS ({rows} of {2 * n})"
    return (f"sqlite {name}: journal_mode {mode}; {n} one-row commits "
            f"{each:.3f} s ({each / n * 1e3:.3f} ms each); one commit of "
            f"{n} rows {one * 1e3:.2f} ms; reopen and count {reopen * 1e3:.2f}"
            f" ms, {rows} rows {ok}")


LOOKUP_MODES = (
    ("default cache", ()),
    ("256 MiB cache", ("PRAGMA cache_size=-262144",)),
    ("256 MiB cache, exclusive", ("PRAGMA cache_size=-262144",
                                  "PRAGMA locking_mode=EXCLUSIVE")),
)


def sqlite_lookups(d: str, n: int = 1_000_000, k: int = 20_000) -> str:
    """Per connection setting of LOOKUP_MODES, on a fresh WAL table of n
    keys (the translate index's pattern): the bulk insert, every key
    looked up in IN queries of 900 (a keyed import's lookups) and k
    single lookups (a query's)."""
    import random

    out = []
    keys = [f"u{i:07d}" for i in range(n)]
    shuffled = random.sample(keys, n)
    single = shuffled[:k]
    for label, pragmas in LOOKUP_MODES:
        path = os.path.join(d, f"lookups-{len(out)}.db")
        db = sqlite3.connect(path)
        db.execute("PRAGMA journal_mode=WAL")
        db.execute("PRAGMA synchronous=OFF")
        for p in pragmas:
            db.execute(p)
        db.execute("CREATE TABLE kv (key TEXT PRIMARY KEY, id INTEGER)"
                   " WITHOUT ROWID")
        db.execute("CREATE UNIQUE INDEX kv_rev ON kv (id)")
        t0 = time.perf_counter()
        db.executemany("INSERT INTO kv VALUES (?, ?)",
                       ((key, i) for i, key in enumerate(keys)))
        db.commit()
        build = time.perf_counter() - t0
        t0 = time.perf_counter()
        for lo in range(0, n, 900):
            part = shuffled[lo:lo + 900]
            db.execute("SELECT key, id FROM kv WHERE key IN ("
                       + ",".join("?" * len(part)) + ")", part).fetchall()
        batched = time.perf_counter() - t0
        t0 = time.perf_counter()
        for key in single:
            db.execute("SELECT id FROM kv WHERE key=?", (key,)).fetchone()
        one = time.perf_counter() - t0
        db.close()
        out.append(f"sqlite lookups, {label}: {n} keys inserted "
                   f"{build / n * 1e6:.2f} us a key; looked up in IN queries "
                   f"of 900 {batched / n * 1e6:.2f} us a key; {k} single "
                   f"lookups {one / k * 1e6:.2f} us each")
    return "\n".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--files", type=int, default=4000)
    ap.add_argument("--dir", default=tempfile.gettempdir())
    ap.add_argument("--sqlite-only", action="store_true",
                    help="run the sqlite probe alone")
    args = ap.parse_args()
    print("RLIMIT_NOFILE (soft, hard):",
          resource.getrlimit(resource.RLIMIT_NOFILE))
    print(subprocess.run(["df", "-hT", args.dir], capture_output=True,
                         text=True).stdout.strip())
    print("sqlite", sqlite3.sqlite_version, flush=True)
    with tempfile.TemporaryDirectory(dir=args.dir) as d:
        for name, pragmas in SQLITE_MODES:
            print(sqlite_probe(d, name, pragmas), flush=True)
        print(sqlite_lookups(d), flush=True)
    if args.sqlite_only:
        return 0
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
