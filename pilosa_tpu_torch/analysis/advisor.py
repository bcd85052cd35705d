"""Placement advisor: dry-run recommendations from the fragment heat map.

Copy of pilosa_tpu/analysis/advisor.py (advise :45, render_advice :142).
Given a heat document (the tracker's `snapshot(top=0)`), and optionally
the residency's occupancy and the federation's per-node summaries, it
recommends placements without acting on any of them. Served at
GET /debug/heat?advice=true and by `python -m pilosa_tpu_torch.cli
advise`.

`advise()` is a pure function of its input documents (no clock, no
randomness), so the same documents give the same advice byte for byte in
either package (tests/test_torch_fleet.py):

* `hbmPinSet`: the hottest fragments (score >= HOT_SCORE), at most top_k.
* `evictionCandidates`: fragments under the hot bar with uploads > 0,
  coldest first.
* `tiers`: projected tier per fragment: `hbm` (score >= HOT_SCORE),
  `host` (touched, under the bar), `cold` (no heat).
* `nodes`: per-node skew against the fleet median and health: a healthy
  node far above it is a rebalancing candidate, an unhealthy one needs an
  operator first.
"""

from __future__ import annotations

from pilosa_tpu_torch.utils.heat import HOT_SCORE

# a node's skew this far above the fleet median flags it for rebalance
NODE_SKEW_RATIO = 2.0
# fleet-level skew worth calling out at all (1.0 = perfectly even)
SKEW_ALERT = 4.0


def _frag_id(e: dict) -> dict:
    return {"index": e.get("index"), "field": e.get("field"),
            "view": e.get("view"), "shard": int(e.get("shard", 0))}


def advise(heat_doc: dict, residency: dict = None,
           budget_bytes: int = 0, nodes: list = None,
           top_k: int = 16) -> dict:
    """Dry-run placement recommendations from a heat document whose `hot`
    carries every tracked fragment. `residency`/`budget_bytes` put the
    pin set beside the device's occupancy; `nodes` is the federation's
    per-node summary list ({id, skew, hotFragments, health})."""
    entries = list(heat_doc.get("hot") or [])
    # re-sorted, so a hand-assembled document gives the same advice
    # (score descending, then the fragment coordinate)
    entries.sort(key=lambda e: (-float(e.get("score", 0.0)),
                                e.get("index") or "", e.get("field") or "",
                                e.get("view") or "",
                                int(e.get("shard", 0))))
    hot = [e for e in entries if float(e.get("score", 0.0)) >= HOT_SCORE]
    pin = [{**_frag_id(e), "score": e.get("score"),
            "readsPerS": e.get("readsPerS"),
            "h2dBytes": e.get("h2dBytes")} for e in hot[:top_k]]
    evict = [{**_frag_id(e), "score": e.get("score"),
              "uploads": e.get("uploads"), "evictions": e.get("evictions")}
             for e in reversed(entries)
             if float(e.get("score", 0.0)) < HOT_SCORE
             and float(e.get("uploads", 0.0)) > 0][:top_k]
    tiers = {"hbm": 0, "host": 0, "cold": 0}
    assignments = []
    for e in entries:
        score = float(e.get("score", 0.0))
        tier = ("hbm" if score >= HOT_SCORE
                else "host" if score > 0.0 else "cold")
        tiers[tier] += 1
        if len(assignments) < 4 * top_k:
            assignments.append({**_frag_id(e), "tier": tier,
                                "score": e.get("score")})
    skew = float(heat_doc.get("skew", 1.0))
    skew_out = {
        "fleet": skew,
        "alert": skew >= SKEW_ALERT,
    }
    node_out = []
    if nodes:
        skews = sorted(float(n.get("skew", 1.0)) for n in nodes)
        median = skews[len(skews) // 2]
        for n in sorted(nodes, key=lambda n: str(n.get("id"))):
            nskew = float(n.get("skew", 1.0))
            health = ((n.get("health") or {}).get("score")
                      if isinstance(n.get("health"), dict)
                      else n.get("health")) or "unknown"
            rec = "ok"
            # far above the fleet median, or past the absolute bar (a
            # fleet hot everywhere must not normalise its own skew away)
            if (median > 0 and nskew >= NODE_SKEW_RATIO * median) \
                    or nskew >= SKEW_ALERT:
                rec = ("rebalance-candidate" if health == "green"
                       else "investigate-health")
            node_out.append({"id": n.get("id"), "skew": nskew,
                             "hotFragments": int(
                                 n.get("hotFragments", 0)),
                             "health": health,
                             "recommendation": rec})
    out = {
        "dryRun": True,  # the advisor never acts
        "hbmPinSet": pin,
        "evictionCandidates": evict,
        "tiers": {**tiers, "assignments": assignments},
        "skew": skew_out,
        "inputs": {
            "trackedFragments": int(heat_doc.get("trackedFragments", 0)),
            "spilledFragments": int(heat_doc.get("spilledFragments", 0)),
            "hotFragments": int(heat_doc.get("hotFragments", 0)),
        },
    }
    if nodes:
        out["nodes"] = node_out
    if residency is not None:
        out["residency"] = {
            "bytes": int(residency.get("bytes", 0)),
            "budget": int(budget_bytes or 0),
            "entries": int(residency.get("entries", 0)),
            "evictions": int(residency.get("evictions", 0)),
        }
    return out


def render_advice(advice: dict) -> str:
    """The advice as lines for a terminal (the `advise` subcommand)."""
    lines = ["placement advice (dry run — nothing is acted on)"]
    pin = advice.get("hbmPinSet") or []
    lines.append(f"  HBM pin set ({len(pin)}):")
    for e in pin:
        lines.append(
            f"    {e['index']}/{e['field']}/{e['view']}/{e['shard']}"
            f"  score={e.get('score')} reads/s={e.get('readsPerS')}")
    ev = advice.get("evictionCandidates") or []
    lines.append(f"  eviction candidates ({len(ev)}):")
    for e in ev:
        lines.append(
            f"    {e['index']}/{e['field']}/{e['view']}/{e['shard']}"
            f"  score={e.get('score')}")
    tiers = advice.get("tiers") or {}
    lines.append(
        f"  projected tiers: hbm={tiers.get('hbm', 0)} "
        f"host={tiers.get('host', 0)} cold={tiers.get('cold', 0)}")
    skew = advice.get("skew") or {}
    lines.append(
        f"  skew: fleet={skew.get('fleet')}"
        + (" ALERT (one fragment set dominates)"
           if skew.get("alert") else ""))
    for n in advice.get("nodes") or []:
        lines.append(
            f"  node {n['id']}: skew={n['skew']} "
            f"hot={n['hotFragments']} health={n['health']} -> "
            f"{n['recommendation']}")
    return "\n".join(lines)
