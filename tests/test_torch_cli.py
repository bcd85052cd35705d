"""The port's command line and TLS against the JAX package's.

`inspect`, `check`, `config` and `generate-config` print what the JAX
commands print for the same files (fragment files of either package,
hint logs, damaged copies of both, a TOML with every served section); an
`import`/`export` round trip through a port server gives the CSV one
through a JAX server gives; `profile-capture` takes a capture on a live
port node. TLS: a port node serves HTTPS with a throwaway certificate,
its internal client trusts it with skip-verify, a mixed port/JAX pair
fans a Count out over HTTPS, and a certificate that does not load stops
the start in both packages with the same error.
"""

import json
import os
import shutil
import ssl
import subprocess
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cli import main as jax_main
from pilosa_tpu.server import Server as JaxServer
from pilosa_tpu.storage.fragment import Fragment as JaxFragment
from pilosa_tpu.storage.hints import HintStore as JaxHints
from pilosa_tpu_torch.cli import main as cli_main
from pilosa_tpu_torch.cli.config import load_config
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.storage.fragment import Fragment
from pilosa_tpu_torch.storage.hints import HintStore

SW = 1 << 20


def _run(main, argv, capsys) -> tuple:
    try:
        rc = main.main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr().out
    return rc, out


def _both(argv, capsys) -> str:
    p = _run(cli_main, argv, capsys)
    j = _run(jax_main, argv, capsys)
    assert p == j, (p, j)
    return p[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Fragment files of both packages (array, bitmap and run containers,
    ops in the WAL), hint logs, and a damaged copy of each kind."""
    d = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 6, 30_000)
    cols = rng.integers(0, 1 << 20, 30_000)
    out = {}
    for name, Frag in (("port", Fragment), ("jax", JaxFragment)):
        path = str(d / f"{name}.frag")
        f = Frag(path, "i", "f", "standard", 0).open()
        f.bulk_import(rows.tolist(), cols.tolist())
        f.bulk_import([7] * 5000, list(range(1000, 6000)))  # a run row
        for c in range(0, 700, 3):
            f.set_bit(8, c)  # WAL ops after the snapshot
        f.close()
        out[name] = path
    for name, Store in (("port", HintStore), ("jax", JaxHints)):
        hs = Store(str(d / f"{name}-hints"))
        for k in range(5):
            hs.append("n1", "i", f"Set({k}, f=1)", shards=[0])
        out[f"{name}-hints"] = hs._path("n1")
    bad = str(d / "bad.frag")
    shutil.copy(out["port"], bad)
    size = os.path.getsize(bad)
    with open(bad, "r+b") as fh:
        fh.seek(size // 3)
        b = fh.read(1)
        fh.seek(size // 3)
        fh.write(bytes([b[0] ^ 0xFF]))
    out["bad"] = bad
    torn = str(d / "torn.hints")
    shutil.copy(out["port-hints"], torn)
    with open(torn, "r+b") as fh:
        fh.truncate(os.path.getsize(torn) - 5)
    out["torn-hints"] = torn
    return out


@pytest.mark.parametrize("which", ["port", "jax", "bad"])
def test_inspect_prints_what_jax_prints(files, which, capsys):
    if which == "bad":
        with pytest.raises(ValueError) as p:
            cli_main.main(["inspect", files[which]])
        with pytest.raises(ValueError) as j:
            jax_main.main(["inspect", files[which]])
        assert str(p.value) == str(j.value)
        return
    out = _both(["inspect", files[which]], capsys)
    doc = json.loads(out)
    assert doc["bits"] > 30_000 and doc["opN"] > 0
    assert set(doc["containerKinds"]) >= {"array", "run"}


def test_check_prints_what_jax_prints(files, capsys):
    good = [files["port"], files["jax"], files["port-hints"],
            files["jax-hints"]]
    out = _both(["check"] + good, capsys)
    assert out.count(": OK (") == 4
    out = _both(["check"] + good + [files["bad"], files["torn-hints"]],
                capsys)
    assert out.count(": FAILED: ") == 2
    assert _run(cli_main, ["check", files["bad"]], capsys)[0] == 1
    assert _run(cli_main, ["check", files["port"]], capsys)[0] == 0


def test_config_and_generate_config_print_what_jax_prints(tmp_path, capsys):
    assert _both(["generate-config"], capsys).startswith("data-dir = ")
    cfg = tmp_path / "n.toml"
    cfg.write_text(
        'data-dir = "/tmp/d"\nbind = "127.0.0.1:10199"\nverbose = true\n'
        '[tls]\ncertificate = "c.pem"\nkey = "k.pem"\nskip-verify = true\n'
        '[cluster]\ndisabled = false\nreplicas = 2\n'
        'hosts = ["http://a:1", "http://b:2"]\nquery-timeout = "2s"\n'
        '[qos]\nmode = "observe"\n[qos.principals."key:etl"]\n'
        'queries-per-s = 5.0\npriority = "batch"\n'
        '[metric]\npoll-interval = 0.5\n'
        '[diagnostics]\nurl = "http://localhost:1/d"\ninterval = 60.0\n'
        '[gossip]\nseeds = ["a:1"]\n')
    out = _both(["config", "--config", str(cfg)], capsys)
    assert 'skip-verify = true' in out and "poll-interval = 0.5" in out
    assert '[qos.principals."key:etl"]' in out


def test_served_keys_reach_the_server(tmp_path):
    cfg = tmp_path / "n.toml"
    cfg.write_text(
        '[tls]\ncertificate = "c.pem"\nkey = "k.pem"\nskip-verify = true\n'
        '[metric]\npoll-interval = "250ms"\n'
        '[diagnostics]\nurl = "http://localhost:1/d"\ninterval = "1m"\n')
    kw = cli_main.server_kwargs(load_config(str(cfg), environ={}))
    assert (kw["tls_certificate"], kw["tls_key"], kw["tls_skip_verify"]) \
        == ("c.pem", "k.pem", True)
    assert kw["metric_poll_interval"] == 0.25
    assert (kw["diagnostics_url"], kw["diagnostics_interval"]) == \
        ("http://localhost:1/d", 60.0)


def test_import_export_round_trip_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 5, 3000)
    cols = rng.integers(0, 3 * SW, 3000)
    csv_in = tmp_path / "in.csv"
    csv_in.write_text("".join(f"{r},{c}\n" for r, c in zip(rows, cols)))
    vals = tmp_path / "vals.csv"
    vals.write_text("".join(f"{c},{c % 1000 - 500}\n"
                            for c in range(0, 2 * SW, 9973)))
    exported = {}
    for name, make in (("port", lambda d: Server(d, port=0,
                                                 device="cpu")),
                       ("jax", lambda d: JaxServer(d, port=0))):
        s = make(str(tmp_path / name)).open()
        try:
            main = cli_main if name == "port" else jax_main
            rc, out = _run(main, ["import", "--host", s.uri, "--index", "i",
                                  "--field", "f", "--create",
                                  "--batch-size", "700", str(csv_in)],
                           capsys)
            assert rc == 0 and "imported 3000 records" in out
            rc, _ = _run(main, ["import", "--host", s.uri, "--index", "i",
                                "--field", "v", "--field-type", "int",
                                "--min", "-500", "--max", "500", "--create",
                                str(vals)], capsys)
            assert rc == 0
            dest = tmp_path / f"{name}.csv"
            rc, _ = _run(main, ["export", "--host", s.uri, "--index", "i",
                                "--field", "f", "-o", str(dest)], capsys)
            assert rc == 0
            exported[name] = dest.read_text()
            q = urllib.request.Request(s.uri + "/index/i/query",
                                       data=b"Sum(field=v)", method="POST")
            with urllib.request.urlopen(q, timeout=20) as resp:
                exported[name + "-sum"] = json.loads(resp.read())
        finally:
            s.close()
    assert exported["port"] == exported["jax"]
    assert exported["port-sum"] == exported["jax-sum"]
    got = sorted(tuple(map(int, line.split(",")))
                 for line in exported["port"].splitlines())
    assert got == sorted(set(zip(rows.tolist(), cols.tolist())))


def test_profile_capture_against_a_live_node(tmp_path, capsys):
    s = Server(str(tmp_path / "n"), port=0, device="cpu").open()
    try:
        rc, out = _run(cli_main, ["profile-capture", "--host", s.uri,
                                  "--seconds", "0.2", "--json"], capsys)
        doc = json.loads(out)
        assert rc == 0 and doc["status"] == "ok"
        assert os.path.exists(doc["trace"]) and os.path.isdir(doc["dir"])
        rc, out = _run(cli_main, ["profile-capture", "--host", s.uri,
                                  "--seconds", "0.1"], capsys)
        assert rc == 0 and out.startswith("captured ")
    finally:
        s.close()


# -- TLS -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    crt, key = str(d / "crt.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-subj", "/CN=localhost", "-keyout", key, "-out", crt, "-days",
         "1"], check=True, capture_output=True)
    return crt, key


def _unverified():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def test_tls_port_node(tmp_path, cert):
    crt, key = cert
    s = Server(str(tmp_path / "n"), port=0, device="cpu",
               tls_certificate=crt, tls_key=key,
               tls_skip_verify=True).open()
    try:
        assert s.uri.startswith("https://")
        with urllib.request.urlopen(s.uri + "/version", timeout=10,
                                    context=_unverified()) as resp:
            assert json.loads(resp.read())["version"]
        assert s.client.status(s.uri)["state"]
        # a client that verifies refuses the self-signed certificate
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(s.uri + "/version", timeout=10)
    finally:
        s.close()


def test_tls_mixed_pair_fans_out_over_https(tmp_path, cert):
    crt, key = cert
    nodes = [Server(str(tmp_path / "p"), port=0, device="cpu",
                    replica_n=1, tls_certificate=crt, tls_key=key,
                    tls_skip_verify=True).open(),
             JaxServer(str(tmp_path / "j"), port=0, replica_n=1,
                       tls_certificate=crt, tls_key=key,
                       tls_skip_verify=True).open()]
    ctx = _unverified()

    def post(uri, path, body):
        req = urllib.request.Request(uri + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=30, context=ctx) as resp:
            return json.loads(resp.read() or b"{}")

    try:
        uris = [n.uri for n in nodes]
        assert all(u.startswith("https://") for u in uris)
        for n in nodes:
            n.cluster_hosts = uris
            n.refresh_membership()
        post(uris[0], "/index/i", b"{}")
        post(uris[0], "/index/i/field/f", b"{}")
        rng = np.random.default_rng(8)
        a = {int(c) for c in rng.integers(0, 8 * SW, 4000)}
        b = {int(c) for c in rng.integers(0, 8 * SW, 4000)}
        for row, cols in ((1, a), (2, b)):
            post(uris[0], "/index/i/field/f/import",
                 json.dumps({"rowIDs": [row] * len(cols),
                             "columnIDs": sorted(cols)}).encode())
        q = b"Count(Intersect(Row(f=1), Row(f=2)))"
        for u in uris:
            assert post(u, "/index/i/query", q)["results"] == [len(a & b)]
        owners = {n.id for s in range(8)
                  for n in nodes[0].cluster.shard_nodes("i", s)}
        assert len(owners) == 2  # both nodes hold shards: it fanned out
    finally:
        for n in nodes:
            n.close()


def test_a_bad_certificate_stops_the_start(tmp_path, cert):
    crt, _key = cert
    bad = tmp_path / "bad.pem"
    bad.write_text("not a key\n")
    errs = []
    for make in (lambda d: Server(d, port=0, device="cpu",
                                  tls_certificate=crt, tls_key=str(bad)),
                 lambda d: JaxServer(d, port=0, tls_certificate=crt,
                                     tls_key=str(bad))):
        # the JAX server binds its listener in __init__, the port's in
        # open(): either way the node never serves
        with pytest.raises(ssl.SSLError) as e:
            make(str(tmp_path / f"n{len(errs)}")).open()
        errs.append((type(e.value), str(e.value).split(" (")[0]))
    assert errs[0] == errs[1]
