"""Residency decisions that read heat, held against the JAX package.

`eviction = "heat"` evicts the occupant whose fragments are coldest, and
the hybrid chooser demotes a band-resident heavier row whose fragments
are all cold. The port's DeviceResidency and HybridManager, each with the
port's HeatTracker, make the same choices as the JAX ones with the JAX
tracker under the same heat (the JAX residency on JAX's CPU backend).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.parallel import residency as jres
from pilosa_tpu.utils import heat as jheat
from pilosa_tpu_torch.device import planes_to_tensor
from pilosa_tpu_torch.parallel import residency as tres
from pilosa_tpu_torch.utils import heat as theat

SHARDS = (0, 1, 2, 3)
LEAF_BYTES = len(SHARDS) * 16 * 4


class _JaxRunner:
    def put_leaf(self, host):
        return jnp.asarray(host)


class _TorchRunner:
    device = torch.device("cpu")

    def put_leaf(self, host):
        return planes_to_tensor(host, "cpu")


def _key(row: int, field: str = "f") -> tuple:
    return ("row", "i", field, "standard", row, SHARDS, (1,) * len(SHARDS))


def _make():
    return np.zeros((len(SHARDS), 16), dtype=np.uint32)


def _pair(eviction: str):
    jt, tt = jheat.HeatTracker(), theat.HeatTracker()
    j = jres.DeviceResidency(_JaxRunner(), budget_bytes=4 * LEAF_BYTES)
    t = tres.DeviceResidency(_TorchRunner())
    t.budget = 4 * LEAF_BYTES
    for r, tr in ((j, jt), (t, tt)):
        r.heat, r.eviction = tr, eviction
    return j, t, jt, tt


@pytest.mark.parametrize("eviction", ["heat", "lru"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eviction_victims_match_jax(seed, eviction):
    """Seeded leaf reads and read heat over a 4-leaf budget: after every
    step both residencies hold the same keys in the same order, and count
    the same heat evictions. Each heated row gets its own read count, so
    no two scores tie; unheated rows (score 0) tie and fall to LRU."""
    rng = np.random.default_rng(seed)
    j, t, jt, tt = _pair(eviction)
    t0 = time.monotonic()
    for step in range(60):
        row = int(rng.integers(12))
        if rng.random() < 0.4 and row % 3:
            for s in SHARDS:
                jt.touch("i", f"f{row}", "standard", s,
                         reads=1 + row * 7, now=t0)
            tt.touch_many(theat.Frags("i", f"f{row}", "standard", SHARDS),
                          reads=1 + row * 7, now=t0)
        key = _key(row, f"f{row}")
        j.leaf(key, _make)
        t.leaf(key, _make)
        assert list(t._lru) == list(j._lru), f"step {step}"
    assert t.evictions == j.evictions > 0
    assert t.heat_evictions == j.heat_evictions
    assert (t.heat_evictions > 0) == (eviction == "heat")
    jtot, ttot = jt.totals(), tt.totals()
    assert ttot["uploads"] == jtot["uploads"] > 0
    assert ttot["evictions"] == jtot["evictions"] > 0


def test_heat_eviction_falls_back_to_lru(monkeypatch):
    """Any kill switch (the env gate, a disabled tracker, no tracker)
    makes heat eviction plain LRU."""
    for kill in ("env", "toggle", "none"):
        j, t, jt, tt = _pair("heat")
        if kill == "env":
            monkeypatch.setenv("PILOSA_TPU_TORCH_HEAT", "0")
            monkeypatch.setenv("PILOSA_TPU_HEAT", "0")
        elif kill == "toggle":
            jt.enabled = tt.enabled = False
        else:
            j.heat = t.heat = None
        for row in range(7):
            j.leaf(_key(row), _make)
            t.leaf(_key(row), _make)
        assert list(t._lru) == list(j._lru) == [_key(r) for r in (3, 4, 5, 6)]
        assert t.heat_evictions == j.heat_evictions == 0
        monkeypatch.delenv("PILOSA_TPU_TORCH_HEAT", raising=False)
        monkeypatch.delenv("PILOSA_TPU_HEAT", raising=False)


def _chooser_run(age_s: float) -> dict:
    """Both choosers over a seeded grid of cardinalities and interval
    counts, each row's fragments read once `age_s` seconds ago; returns
    the port's counters after asserting every choice equal."""
    jt, tt = jheat.HeatTracker(), theat.HeatTracker()
    j = jres.HybridManager(threshold=4096, heat=jt, run_threshold=2048)
    t = tres.HybridManager(threshold=4096, heat=tt, run_threshold=2048)
    shards = (0, 1, 2)
    touched = time.monotonic() - age_s
    rng = np.random.default_rng(4)
    for row in range(40):
        field = f"f{row}"
        jkeys = [("i", field, "standard", s) for s in shards]
        tfr = theat.Frags("i", field, "standard", shards)
        jt.touch_many(jkeys, reads=1, now=touched)
        tt.touch_many(tfr, reads=1, now=touched)
        key = ("i", field, "standard", row)
        for _ in range(4):
            card = int(rng.choice([100, 3200, 3900, 5000, 9000]))
            stats = (int(rng.choice([100, 1600, 1900, 3000])), 7)
            if rng.random() < 0.3:
                stats = None
            got = t.choose(key, card, tfr, run_stats=stats)
            assert got == j.choose(key, card, jkeys, run_stats=stats)
            if rng.random() < 0.5:
                t.observe(key, card, tfr, run_stats=stats)
                j.observe(key, card, jkeys, run_stats=stats)
    tsnap = t.snapshot()
    assert tsnap == j.snapshot()
    return tsnap


@pytest.mark.parametrize("age_s", [5.0, 900.0], ids=["hot", "cold"])
def test_hybrid_chooser_matches_jax_under_heat(age_s):
    """A row made dense or run above a threshold, then seen in the band
    under it: same choices and counters as the JAX chooser, whether its
    fragments are hot (read 5 s ago) or cold (15 minutes ago)."""
    snap = _chooser_run(age_s)
    assert snap["demoted"] > 0 and snap["promoted"] > 0


def test_cold_rows_demote_inside_the_band():
    """Inside a band only cold fragments demote a heavier row: the cold
    run demotes more often than the hot one; without a tracker a row is
    never cold."""
    assert _chooser_run(900.0)["demoted"] > _chooser_run(5.0)["demoted"]
    assert not tres.HybridManager()._cold(
        theat.Frags("i", "f", "standard", (0,)))
