"""The fleet view's modules against their JAX originals, at unit level.

The same seeded documents go through both packages and must give equal
results (exact equality throughout): the placement advisor's advice and
its rendering (analysis/advisor.py), the heat merge (utils/heat.py
merge_heat_docs), the span flattening and both batch formats
(utils/tracing.py profile_to_spans, spans_to_jaeger, spans_to_otlp, with
span ids pinned to a counter in both modules), the trace exporter's
sampling, kill switch and file spool, the tracer's sampler, and the
SpanExporter's POST body. The configuration keys of trace export and
[tracing] are served with the JAX defaults, and the dashboard names no
external asset and fetches only routes the port serves.
"""

import itertools
import json
import re
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.analysis import advisor as jadv
from pilosa_tpu.utils import heat as jheat
from pilosa_tpu.utils import tracing as jtr
from pilosa_tpu_torch.analysis import advisor as tadv
from pilosa_tpu_torch.cli import config as tconfig
from pilosa_tpu_torch.utils import heat as theat
from pilosa_tpu_torch.utils import tracing as ttr

_VIEWS = (("i", "f", "standard"), ("i", "g", "standard"),
          ("i", "v", "bsig_v"), ("j", "f", "standard_2024"))


def _heat_doc(rng, n: int) -> dict:
    """A /debug/heat?top=0 document: n fragments, scores spread over
    hot, warm and cold (zero), in no particular order."""
    hot = []
    seen = set()
    while len(hot) < n:
        idx, fld, view = _VIEWS[int(rng.integers(len(_VIEWS)))]
        shard = int(rng.integers(0, 64))
        if (idx, fld, view, shard) in seen:
            continue
        seen.add((idx, fld, view, shard))
        band = int(rng.integers(3))
        score = (0.0 if band == 0 else
                 round(float(rng.random()) * 9e-4, 6) if band == 1 else
                 round(1e-3 + float(rng.exponential(0.2)), 6))
        hot.append({
            "index": idx, "field": fld, "view": view, "shard": shard,
            "score": score,
            "readsPerS": round(float(rng.random()), 6),
            "writesPerS": round(float(rng.random()) * 0.1, 6),
            "reads": float(rng.integers(0, 50)),
            "writes": float(rng.integers(0, 5)),
            "deviceMs": round(float(rng.random()) * 3, 3),
            "h2dBytes": float(rng.integers(0, 1 << 20)),
            "uploads": float(rng.integers(0, 3)),
            "evictions": float(rng.integers(0, 2)),
            "lastReadAgeS": 1.5, "lastWriteAgeS": None})
    scores = [e["score"] for e in hot]
    mean = sum(scores) / len(scores)
    return {"hot": hot, "cold": [],
            "totals": {f: round(sum(e[f] for e in hot), 3)
                       for f in theat.FIELDS},
            "trackedFragments": n,
            "spilledFragments": int(rng.integers(0, 4)),
            "hotFragments": sum(1 for s in scores if s >= theat.HOT_SCORE),
            "skew": round(max(scores) / mean, 4) if mean > 0 else 1.0}


def _nodes(rng, k: int) -> list:
    out = []
    for i in range(k):
        health = ["green", "yellow", "red", None][int(rng.integers(4))]
        out.append({"id": f"node{k - i}",
                    "skew": round(1.0 + float(rng.exponential(2.0)), 4),
                    "hotFragments": int(rng.integers(0, 40)),
                    # the federation's entries carry a {score} dict; a
                    # hand-written list may carry the bare score
                    "health": ({"score": health} if i % 2 else health)})
    return out


def test_advisor_constants_match_jax():
    assert (tadv.NODE_SKEW_RATIO, tadv.SKEW_ALERT, theat.HOT_SCORE) == \
        (jadv.NODE_SKEW_RATIO, jadv.SKEW_ALERT, jheat.HOT_SCORE)


@pytest.mark.parametrize("seed", range(6))
def test_advise_matches_jax_byte_for_byte(seed):
    rng = np.random.default_rng(seed)
    doc = _heat_doc(rng, int(rng.integers(1, 90)))
    residency = {"bytes": int(rng.integers(0, 1 << 30)), "entries": 7,
                 "evictions": int(rng.integers(0, 9))}
    cases = [dict(), dict(top_k=3),
             dict(residency=residency, budget_bytes=1 << 31),
             dict(nodes=_nodes(rng, 1 + seed % 4), top_k=5)]
    for kw in cases:
        got, want = tadv.advise(doc, **kw), jadv.advise(doc, **kw)
        assert json.dumps(got, sort_keys=False) == \
            json.dumps(want, sort_keys=False)
        assert tadv.render_advice(got) == jadv.render_advice(want)


def test_advise_from_twin_trackers_matches_jax():
    """Both trackers charged alike at pinned times: their snapshots, and
    the advice on them, are equal."""
    rng = np.random.default_rng(7)
    J, T = jheat.HeatTracker(), theat.HeatTracker()
    now = 5000.0
    for _ in range(200):
        now += float(rng.exponential(20.0))
        g = _VIEWS[int(rng.integers(3))]
        keys = [(*g, int(s)) for s in sorted(set(
            rng.integers(0, 16, size=int(rng.integers(1, 6))).tolist()))]
        kw = ({"reads": 1} if rng.random() < 0.6 else
              {"h2d_bytes": 4096, "uploads": 1})
        J.touch_many(keys, now=now, **kw)
        T.touch_many(keys, now=now, **kw)
    now += 1800.0  # half an hour on: some fall under the hot bar
    jdoc, tdoc = J.snapshot(top=0, now=now), T.snapshot(top=0, now=now)
    assert tdoc == jdoc
    advice = tadv.advise(tdoc, top_k=4)
    assert advice == jadv.advise(jdoc, top_k=4)
    assert advice["hbmPinSet"] and advice["evictionCandidates"]


@pytest.mark.parametrize("seed", range(4))
def test_merge_heat_docs_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    docs = {f"node{i}": _heat_doc(rng, int(rng.integers(0, 40)))
            for i in range(3)}
    # replicas: the second node reports some of the first's fragments
    docs["node1"]["hot"] += [dict(e) for e in docs["node0"]["hot"][::2]]
    got, want = theat.merge_heat_docs(docs), jheat.merge_heat_docs(docs)
    assert json.dumps(got) == json.dumps(want)
    assert theat.merge_heat_docs({}) == jheat.merge_heat_docs({})


# ---------------------------------------------------------------- spans


@pytest.fixture
def pinned_ids(monkeypatch):
    """Span ids from one counter per module, so both packages draw the
    same ids in the same order."""
    for mod in (jtr, ttr):
        counter = itertools.count(1)
        monkeypatch.setattr(mod, "_new_span_id",
                            lambda c=counter: f"{next(c):016x}")


def _profile(rng, depth: int, node: str, trace: str) -> dict:
    """A cross-node profile tree as utils/profile.py to_dict writes it:
    calls, fan-out records (hedge and failover kinds among them),
    dispatches and remote trees under the fan-out nodes."""
    peers = [f"n{depth}{k}" for k in range(int(rng.integers(0, 3)))]
    fanout = [{"node": p, "shards": int(rng.integers(1, 9)),
               "ms": round(float(rng.random()) * 5, 3),
               "transport": ["coalesced", "direct"][k % 2],
               "hedge": bool(k % 2) or None}
              for k, p in enumerate(peers)]
    if peers and rng.random() < 0.5:
        fanout.append({"kind": "failover", "node": peers[0],
                       "from": peers[0], "to": node, "shards": 2})
    return {
        "traceId": trace, "node": node, "index": "i",
        "pql": "Count(Intersect(Row(f=1), Row(f=2)))",
        "startWall": round(1.7e9 + float(rng.random()), 6),
        "elapsedMs": round(float(rng.random()) * 20, 3),
        "calls": [{"call": c, "ms": round(float(rng.random()), 3)}
                  for c in ("Count", "Intersect")[:int(rng.integers(1, 3))]],
        "fanout": fanout,
        "dispatches": [{"batcher": "CountBatcher", "dispatch": 3,
                        "batchSize": int(rng.integers(1, 64)),
                        "wallMs": 1.5, "shareMs": 0.25}],
        "residency": {"hits": 1, "misses": 0, "hostToDeviceBytes": 0},
        "plan": [], "route": [],
        "remoteProfiles": [
            {"node": f"http://{p}:10101",
             "profile": (_profile(rng, depth + 1, p, trace)
                         if depth < 2 else None)}
            for p in peers],
    }


@pytest.mark.parametrize("seed", range(4))
def test_profile_spans_and_batches_match_jax(seed, pinned_ids):
    rng = np.random.default_rng(200 + seed)
    prof = _profile(rng, 0, "node0", f"{seed + 1:016x}")
    spans = ttr.profile_to_spans(prof)
    want = jtr.profile_to_spans(prof)
    assert spans == want
    for svc in ("pilosa-tpu", "other"):
        assert ttr.spans_to_jaeger(spans, svc) == \
            jtr.spans_to_jaeger(want, svc)
        assert ttr.spans_to_otlp(spans, svc) == \
            jtr.spans_to_otlp(want, svc)
    # one trace, and every remote tree grafted under a fan-out span
    assert {s["traceID"] for s in spans} == {prof["traceId"]}
    by_id = {s["spanID"]: s for s in spans}
    for s in spans:
        if s["operationName"] == "pilosa.query" and s["parentSpanID"]:
            assert by_id[s["parentSpanID"]]["operationName"].startswith(
                "fanout.")


def _trace_ids(n: int) -> list:
    rng = np.random.default_rng(300)
    return [f"{int(x):016x}" for x in
            rng.integers(0, 1 << 62, size=n, dtype=np.int64)] + ["", "abc"]


@pytest.mark.parametrize("sample", [0.0, 0.01, 0.3, 0.77, 1.0])
def test_exporter_sampling_matches_jax(sample, tmp_path):
    t = ttr.TraceExporter(path=str(tmp_path / "t"), sample=sample,
                          flush_interval=0)
    j = jtr.TraceExporter(path=str(tmp_path / "j"), sample=sample,
                          flush_interval=0)
    ids = _trace_ids(400)
    assert [t.sampled(i) for i in ids] == [j.sampled(i) for i in ids]
    t.close()
    j.close()


@pytest.mark.parametrize("kind,param", [("const", 1.0), ("const", 0.5),
                                        ("probabilistic", 0.25),
                                        ("off", 1.0)])
def test_tracer_sampler_matches_jax(kind, param):
    class Sink:
        def export(self, span):
            pass

    t = ttr.Tracer(exporter=Sink(), sampler_type=kind, sampler_param=param)
    j = jtr.Tracer(exporter=Sink(), sampler_type=kind, sampler_param=param)
    for tid in _trace_ids(300):
        assert t._sampled(ttr.Span(t, "x", tid)) == \
            j._sampled(jtr.Span(j, "x", tid))
    # no exporter: nothing is sampled, whatever the sampler
    assert not ttr.Tracer()._sampled(ttr.Span(None, "x", "1"))


def test_exporter_kill_switch_sampling_and_validation(tmp_path,
                                                      monkeypatch):
    """tests/test_accounting.py:256 on the port's exporter."""
    spool = tmp_path / "spool.jsonl"
    prof = _profile(np.random.default_rng(1), 0, "coord", "feedc0de")
    exp = ttr.TraceExporter(mode="file", path=str(spool), flush_interval=0)
    monkeypatch.setenv("PILOSA_TPU_TRACE_EXPORT", "0")
    exp.export_profile(prof)
    exp.flush()
    assert not spool.exists() and exp.exported == 0
    monkeypatch.delenv("PILOSA_TPU_TRACE_EXPORT")
    exp0 = ttr.TraceExporter(mode="file", path=str(spool), sample=0.0,
                             flush_interval=0)
    exp0.export_profile(prof)
    exp0.flush()
    assert not spool.exists()
    exp.export_profile(prof)
    exp.flush()
    assert spool.exists()
    exp.close()
    exp0.close()
    for kw in (dict(mode="carrier-pigeon", path="x"),
               dict(mode="file", path=""), dict(mode="http"),
               dict(mode="file", path="x", fmt="zipkin")):
        with pytest.raises(ValueError) as tv:
            ttr.TraceExporter(**kw)
        with pytest.raises(ValueError) as jv:
            jtr.TraceExporter(**kw)
        assert str(tv.value) == str(jv.value)


@pytest.mark.parametrize("fmt", ["jaeger", "otlp"])
def test_file_spool_round_trips_like_jax(fmt, tmp_path, pinned_ids):
    """tests/test_accounting.py:224: profile trees and flat spans into a
    spool, one JSON batch a line; the port's lines equal the JAX
    exporter's, and the exported and dropped counts too."""
    rng = np.random.default_rng(9)
    profs = [_profile(rng, 0, "coord", f"{k + 1:016x}") for k in range(3)]
    lines = {}
    for name, mod in (("t", ttr), ("j", jtr)):
        path = tmp_path / f"{name}.jsonl"
        exp = mod.TraceExporter(mode="file", path=str(path), fmt=fmt,
                                batch_size=10_000, flush_interval=0)
        tracer = mod.Tracer(exporter=exp)
        for p in profs:
            exp.export_profile(p)
        span = tracer.start_span("executor.Count", trace_id="00000000000000aa")
        span.set_tag("index", "i")
        span.start_wall, span.start, span.end = 1.7e9, 10.0, 10.25
        tracer._record(span)
        exp.flush()
        exp.export_profile(profs[0])
        exp.close()
        lines[name] = (path.read_text().splitlines(), exp.exported,
                       exp.dropped)
    assert lines["t"] == lines["j"]
    batches = [json.loads(x) for x in lines["t"][0]]
    assert len(batches) == 2
    n = sum(len(b["spans"]) if fmt == "jaeger" else
            len(b["resourceSpans"][0]["scopeSpans"][0]["spans"])
            for b in batches)
    assert n == lines["t"][1] > 0


def test_span_exporter_body_matches_jax(monkeypatch):
    """The [tracing] agent's POST: the same JSON body from both packages
    (urlopen replaced: nothing leaves the process)."""
    bodies = []

    class Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def urlopen(req, timeout=None):
        bodies.append((req.full_url, req.get_method(), req.data))
        return Resp()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for mod in (ttr, jtr):
        exp = mod.SpanExporter("http://127.0.0.1:1/api/traces",
                               flush_interval=0)
        tracer = mod.Tracer(exporter=exp)
        for k in range(3):
            span = tracer.start_span(f"s{k}", trace_id=f"{k:016x}")
            span.set_tag("k", k)
            span.start_wall, span.start, span.end = 1.7e9 + k, 1.0, 1.5
            tracer._record(span)
        exp.close()
        assert exp.exported == 3
    assert len(bodies) == 2 and bodies[0] == bodies[1]


# ---------------------------------------------------------------- config


def test_trace_config_keys_are_served_with_jax_defaults():
    from pilosa_tpu.cli.config import Config as JConfig
    j = JConfig()
    cfg = tconfig.load_config(None, environ={})
    for key in ("trace_export", "trace_export_path", "trace_export_endpoint",
                "trace_export_format", "trace_export_sample"):
        assert key in tconfig.PORTED["metric"]
        assert cfg.get("metric", key) == getattr(j.metric, key)
    for key in ("sampler_type", "sampler_param", "agent_host_port"):
        assert key in tconfig.PORTED["tracing"]
        assert cfg.get("tracing", key) == getattr(j.tracing, key)
    doc = tconfig.__doc__
    assert "tracing export" not in doc and "trace-export-sample" in doc


def test_trace_config_from_toml_and_environment(tmp_path):
    from pilosa_tpu_torch.cli.main import server_kwargs
    path = tmp_path / "n.toml"
    path.write_text('[metric]\ntrace-export = "file"\n'
                    'trace-export-format = "otlp"\n'
                    "trace-export-sample = 0.25\n"
                    '[tracing]\nsampler-type = "probabilistic"\n'
                    "sampler-param = 0.5\n"
                    'agent-host-port = "127.0.0.1:6831"\n')
    cfg = tconfig.load_config(str(path), environ={
        "PILOSA_TPU_METRIC_TRACE_EXPORT_PATH": "/x/spool.jsonl"})
    kw = server_kwargs(cfg)
    assert {k: kw[k] for k in kw if k.startswith("trac")} == {
        "trace_export": "file", "trace_export_path": "/x/spool.jsonl",
        "trace_export_endpoint": "", "trace_export_format": "otlp",
        "trace_export_sample": 0.25,
        "tracing_sampler_type": "probabilistic",
        "tracing_sampler_param": 0.5,
        "tracing_endpoint": "127.0.0.1:6831"}


@pytest.mark.parametrize("kw", [dict(trace_export="sometimes"),
                                dict(trace_export="file",
                                     trace_export_format="zipkin"),
                                dict(trace_export="http")])
def test_bad_trace_export_values_refused_with_jax_texts(kw, tmp_path):
    from pilosa_tpu.server import Server as JaxServer
    from pilosa_tpu_torch.server import Server
    with pytest.raises(ValueError) as tv:
        Server(str(tmp_path / "p"), device="cpu", **kw)
    with pytest.raises(ValueError) as jv:
        JaxServer(str(tmp_path / "j"), **kw)
    assert str(tv.value) == str(jv.value)


# ---------------------------------------------------------------- dashboard

# tests/test_telemetry.py:324: no external reference of any kind
_EXTERNAL_REF = re.compile(
    r"https?://|href\s*=|src\s*=|url\s*\(|@import|<link|<iframe|"
    r"integrity=|crossorigin", re.IGNORECASE)


def test_dashboard_source_is_self_contained_and_fetches_port_routes():
    from pilosa_tpu_torch.net import http_server
    from pilosa_tpu_torch.net.dashboard import render_dashboard
    html = render_dashboard()
    assert not _EXTERNAL_REF.findall(html)
    assert "<svg" in html or "spark" in html
    paths = re.findall(r'fetch\("([^"?]+)', html)
    assert paths == ["/debug/timeseries", "/debug/usage", "/debug/heat",
                     "/debug/events", "/cluster/stats"]
    for p in paths:
        assert any(m == "GET" and rx.match(p)
                   for m, rx, _ in http_server.ROUTES), p
    # no XLA series: the port draws device memory and kernel launches
    assert "xla." not in html
    assert '"device.bytes_in_use"' in html
    assert '"kernels.dispatches_per_s"' in html
