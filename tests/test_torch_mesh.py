"""The port's replica x shard mesh against the JAX package's, on the CPU.

The JAX package's mesh runs on the 8 virtual CPU devices tests/conftest.py
forces; the port's runs on a list of 8 CPU positions, one torch device
standing at all of them. Mesh construction and the [mesh] rules, leaf
placement with both pad fills, the serving forms, the replica-scattered
pair stream, both mesh kernels (plain, against the Pallas forms in
interpret mode, as tests/test_pallas.py runs them), the batcher's replica
scatter and the GroupBy mesh forms must agree exactly, at a shard count
the slots divide and at a ragged one.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel import mesh as jmesh
from pilosa_tpu.parallel.batcher import CountBatcher as JaxCountBatcher
from pilosa_tpu_torch.device import planes_to_tensor
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.ops.hybrid import RUN_SENTINEL, SPARSE_SENTINEL
from pilosa_tpu_torch.parallel import mesh as pmesh
from pilosa_tpu_torch.parallel.batcher import CountBatcher
from pilosa_tpu_torch.parallel.blocks import Blocked

CPU8 = [torch.device("cpu")] * 8
W = 1024  # a multiple of 128, as the Pallas forms' tiling asks
PROGRAMS = [
    ("and", ("leaf", 0), ("leaf", 1)),
    ("andnot", ("or", ("leaf", 0), ("leaf", 1)), ("leaf", 2)),
    ("xor", ("leaf", 2), ("and", ("leaf", 0), ("leaf", 1), ("leaf", 2))),
]


def _meshes(replicas: int):
    return (pmesh.make_mesh(CPU8, replicas=replicas),
            jmesh.make_mesh(replicas=replicas))


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def _host(x) -> np.ndarray:
    """A port result as uint32 words (a blocked one gathered)."""
    t = x.gather() if isinstance(x, Blocked) else x
    return t.contiguous().cpu().numpy().view(np.uint32)


# -- the mesh and its configuration -----------------------------------------


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_make_mesh_matches_jax(replicas):
    pm, jm = _meshes(replicas)
    assert pm.shape == dict(jm.shape)
    assert pm.axis_names == tuple(jm.axis_names)
    assert pm.size == jm.size == 8
    with pytest.raises(ValueError) as pe:
        pmesh.make_mesh(CPU8, replicas=3)
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh(replicas=3)
    assert str(pe.value) == str(je.value)


def test_group_by_slice_and_multislice_fallback(monkeypatch):
    class Dev:
        def __init__(self, s):
            self.slice_index = s

    devs = [Dev(1), Dev(0), Dev(1), Dev(0)]
    assert pmesh.group_by_slice(devs) == jmesh.group_by_slice(devs)
    assert len(pmesh.group_by_slice(CPU8)) == 1
    single = pmesh.make_multislice_mesh(CPU8)
    assert single.axis_names == (pmesh.SHARD_AXIS,) == \
        jmesh.make_multislice_mesh().axis_names
    assert single.size == 8
    # two simulated slices: one replica row per slice
    monkeypatch.setattr(pmesh, "group_by_slice",
                        lambda ds: [list(ds[:4]), list(ds[4:])])
    two = pmesh.make_multislice_mesh(CPU8)
    assert two.shape == {"replica": 2, "shard": 4}


@pytest.mark.parametrize("devices,replicas", [
    ("none", 1), ("auto", 1), ("auto", 2), ("auto", 0), ("4", 2), ("1", 1),
    ("2", 1), ("9", 1), ("0", 1), ("x", 1)])
def test_mesh_from_config_follows_the_jax_rules(devices, replicas):
    """host-devices = 8 (the JAX side's 8 CPU devices): the same mesh
    shape, None, or error text."""
    def build(mod):
        try:
            m = mod.mesh_from_config(devices=devices, platform="",
                                     host_devices=8, replicas=replicas)
        except ValueError as e:
            return "error", str(e)
        return None if m is None else dict(m.shape)

    assert build(pmesh) == build(jmesh)


def test_host_devices_give_a_cpu_mesh():
    m = pmesh.mesh_from_config(host_devices=4, replicas=2)
    assert m.shape == {"replica": 2, "shard": 2}
    assert {d.type for d in m.devices.flat} == {"cpu"}
    assert pmesh.mesh_from_config(platform="cpu") is None  # one CPU device


# -- placement ----------------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("s", [8, 5])
def test_put_leaf_pads_with_both_fills(replicas, s):
    pm, jm = _meshes(replicas)
    pr, jr = pmesh.DeviceRunner("cpu", mesh=pm), jmesh.DeviceRunner(jm)
    rng = np.random.default_rng(s)
    dense = _words(rng, s, W)
    sparse = np.sort(rng.integers(0, 1 << 20, size=(s, 16)),
                     axis=1).astype(np.int32)
    runs = np.full((s, 2, 4), RUN_SENTINEL, dtype=np.int32)
    runs[:, 0, 0], runs[:, 1, 0] = 10, 20
    for host, put, fill in (
            (dense, pr.put_leaf, 0),
            (sparse, pr.put_index_leaf, SPARSE_SENTINEL),
            (runs, pr.put_index_leaf, RUN_SENTINEL)):
        got = put(host)
        want = np.asarray(jr.put_leaf(host, fill=fill))
        assert isinstance(got, Blocked) and got.shape == want.shape
        assert got.nbytes == want.nbytes  # one copy, as jax.Array counts
        g = got.gather().numpy()
        np.testing.assert_array_equal(g.view(want.dtype), want)
        assert (g[s:] == fill).all()
        ptrs = {ptr for ptr, _ in got.storages()}
        assert len(ptrs) == 8  # one allocation per position
        for r in range(got.n_replicas):  # every replica row a full copy
            for j in range(got.n_slots):
                assert torch.equal(got.blocks[r][j], got.blocks[0][j])
    slab = _words(rng, 3, s, W)
    got = pr.put_plane_slab(slab)
    np.testing.assert_array_equal(_host(got),
                                  np.asarray(jr.put_plane_slab(slab)))


# -- the serving forms --------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("s", [8, 6])
def test_eval_count_and_row_mesh_match_jax(replicas, s):
    pm, jm = _meshes(replicas)
    pr, jr = pmesh.DeviceRunner("cpu", mesh=pm), jmesh.DeviceRunner(jm)
    assert pr.ici_serving and jr.ici_serving
    rng = np.random.default_rng(11 + s)
    host = [_words(rng, s, W) for _ in range(3)]
    pl = [pr.put_leaf(h) for h in host]
    jl = tuple(jr.put_leaf(h) for h in host)
    s0 = pmesh.ici_program_cache_stats()
    for program in PROGRAMS:
        assert pmesh.eval_count_mesh(pm, pl, program) == \
            int(jmesh.eval_count_mesh(jm, jl, program))
        assert pr.count_total_leaves(pl, program) == \
            jr.count_total_leaves(list(jl), program)
        row = pmesh.eval_row_mesh(pm, pl, program)
        assert isinstance(row, Blocked)  # stays blocked, never gathered
        np.testing.assert_array_equal(
            _host(row)[:s], np.asarray(jmesh.eval_row_mesh(jm, jl,
                                                           program))[:s])
    s1 = pmesh.ici_program_cache_stats()
    pmesh.eval_count_mesh(pm, pl, PROGRAMS[0])
    s2 = pmesh.ici_program_cache_stats()
    assert s1["misses"] >= s0["misses"] + 2 * len(PROGRAMS)
    assert s2["hits"] == s1["hits"] + 1 and s2["misses"] == s1["misses"]
    off = pmesh.DeviceRunner("cpu", mesh=pm, ici_serving=False)
    assert not off.ici_serving
    assert off.count_total_leaves(pl, PROGRAMS[1]) == \
        pr.count_total_leaves(pl, PROGRAMS[1])


@pytest.mark.parametrize("replicas", [1, 2])
def test_replica_scattered_pair_stream_matches_jax(replicas):
    pm, jm = _meshes(replicas)
    pr, jr = pmesh.DeviceRunner("cpu", mesh=pm), jmesh.DeviceRunner(jm)
    rng = np.random.default_rng(12)
    host = _words(rng, 6, 5, W)  # ragged: 5 shards on 4 or 8 slots
    leaves = [pr.put_leaf(host[r]) for r in range(6)]
    jslab = jax.numpy.stack([jr.put_leaf(host[r]) for r in range(6)])
    k = 7  # odd: padded to a multiple of the replicas
    ii = rng.integers(0, 6, size=k).astype(np.int32)
    jj = rng.integers(0, 6, size=k).astype(np.int32)
    got = pmesh.pair_stream_counts(pm, leaves, ii, jj)
    want = jmesh.pair_stream_counts(jm, jslab, ii, jj)
    assert got.dtype == np.int64 and got.shape == (k,)
    np.testing.assert_array_equal(got, want)
    parts, real = pmesh.scatter_queries(pm, ii, jj)
    assert real == k and len(parts) == pm.shape.get("replica", 1)
    assert sum(len(p[0]) for p in parts) == k + (-k) % len(parts)


# -- the two mesh kernels -----------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("s", [8, 5])
def test_program_count_mesh_plain_matches_pallas(replicas, s):
    pm, jm = _meshes(replicas)
    pr, jr = pmesh.DeviceRunner("cpu", mesh=pm), jmesh.DeviceRunner(jm)
    rng = np.random.default_rng(17 + s)
    host = [_words(rng, s, W) for _ in range(3)]
    pl = [pr.put_leaf(h) for h in host]
    jl = tuple(jr.put_leaf(h) for h in host)
    for program in PROGRAMS + [("leaf", 1)]:
        want = int(pk.program_count_mesh(jm, jl, program))
        assert kernels.program_count_mesh_plain(pm, pl, program) == want
        assert kernels.program_count_mesh(pm, pl, program) == want
    # the CPU launches nothing: neither the blocks nor the mesh call count
    assert kernels.mesh_launch_counts()["program_count_mesh"] == 0


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("s", [8, 5])
def test_pair_stream_counts_mesh_plain_matches_pallas(replicas, s):
    pm, jm = _meshes(replicas)
    pr, jr = pmesh.DeviceRunner("cpu", mesh=pm), jmesh.DeviceRunner(jm)
    rng = np.random.default_rng(19 + s)
    host = _words(rng, 6, s, W)
    rows = pr.put_plane_slab(host)  # one blocked [R, S, W] slab
    jrows = jr.put_plane_slab(host)
    k = 10 + replicas - 1
    ii = rng.integers(0, 6, size=k).astype(np.int32)
    jj = rng.integers(0, 6, size=k).astype(np.int32)
    want = np.asarray(pk.pair_stream_counts_mesh(jm, jrows, ii, jj))
    np.testing.assert_array_equal(
        kernels.pair_stream_counts_mesh_plain(pm, rows, ii, jj), want)
    np.testing.assert_array_equal(
        kernels.pair_stream_counts_mesh(pm, rows, ii, jj), want)
    leaves = [pr.put_leaf(host[r]) for r in range(6)]
    for op in kernels.PAIR_OPS:
        got = kernels.pair_stream_counts_mesh_plain(pm, leaves, ii, jj, op)
        fn = {"and": np.bitwise_and, "or": np.bitwise_or,
              "xor": np.bitwise_xor,
              "andnot": lambda a, b: a & ~b, "id": lambda a, b: a}[op]
        np.testing.assert_array_equal(got, [
            int(np.bitwise_count(fn(host[i], host[j])).sum())
            for i, j in zip(ii, jj)])


def test_mesh_kernels_refuse_unblocked_or_foreign_leaves():
    pm = pmesh.make_mesh(CPU8, replicas=2)
    other = pmesh.DeviceRunner("cpu", mesh=pmesh.make_mesh(CPU8))
    plain = planes_to_tensor(np.zeros((8, W), np.uint32), "cpu")
    with pytest.raises(TypeError):
        kernels.program_count_mesh(pm, [plain], ("leaf", 0))
    with pytest.raises(ValueError):
        kernels.pair_stream_counts_mesh(
            pm, [other.put_leaf(np.zeros((8, W), np.uint32))], [0], [0])


# -- the batcher's replica scatter --------------------------------------------


def test_batcher_replica_scatter_matches_jax(monkeypatch):
    """Concurrent Counts through the CountBatcher on a 2 x 4 mesh
    (after tests/test_batcher.py:421): exact against numpy and the JAX
    batcher, and each replica row counts half of every batch's pairs."""
    pm, jm = _meshes(2)
    pr, jr = pmesh.DeviceRunner("cpu", mesh=pm), jmesh.DeviceRunner(jm)
    rng = np.random.default_rng(31)
    host = [_words(rng, 6, 64) for _ in range(4)]
    leaves = [pr.put_leaf(h) for h in host]
    jleaves = [jr.put_leaf(h) for h in host]
    b, jb = CountBatcher(runner=pr), JaxCountBatcher(runner=jr)
    widths = []
    real = kernels.pair_stream_counts

    def spy(lv, ii, jj, op="and"):
        widths.append((threading.get_ident(), len(ii)))
        return real(lv, ii, jj, op)

    monkeypatch.setattr(kernels, "pair_stream_counts", spy)
    results, errors = {}, []
    start = threading.Barrier(8)

    def client(tid):
        start.wait()
        try:
            for q in range(6):
                i, j = (tid + q) % 4, (tid + q + 1) % 4
                op = ("and", "or", "xor", "andnot")[q % 4]
                results[(tid, q)] = (b.count(op, leaves[i], leaves[j]),
                                     jb.count(op, jleaves[i], jleaves[j]))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    assert len(results) == 48
    for got, want in results.values():
        assert got == want
    assert b.count("id", leaves[2], None) == \
        int(np.bitwise_count(host[2]).sum())
    # per batch (one leader thread's run of launches): 2 replica rows x 4
    # slots, each row half of the pairs (padded to an even count)
    by_thread: dict = {}
    for tid, n in widths:
        by_thread.setdefault(tid, []).append(n)
    assert by_thread
    for seq in by_thread.values():
        assert len(seq) % 8 == 0
        for n in range(0, len(seq), 8):
            assert len(set(seq[n:n + 8])) == 1


# -- the GroupBy mesh forms ---------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("s", [4, 5])
def test_groupby_mesh_forms_match_jax(replicas, s):
    """After tests/test_groupby_parity.py:64 and test_pallas.py's chunk
    parity: the summed count matrix and its prune."""
    pm, jm = _meshes(replicas)
    pr, jr = pmesh.DeviceRunner("cpu", mesh=pm), jmesh.DeviceRunner(jm)
    rng = np.random.default_rng(23 + s)
    host_a = _words(rng, 6, s, 512)
    host_b = _words(rng, 5, s, 512)
    host_a[2] = 0  # a dead prefix
    idx = [np.array([0, 2, 5, 0], dtype=np.int32)]
    pa, pb = pr.put_plane_slab(host_a), pr.put_plane_slab(host_b)
    ja, jb = jr.put_plane_slab(host_a), jr.put_plane_slab(host_b)
    jidx = (jax.numpy.asarray(idx[0]),)
    for n_valid, bound in ((3, 30), (3, 4), (4, 30)):
        got = pr.groupby_chunk([pa], idx, pb, n_valid, bound)
        want = jax.device_get(jr.groupby_chunk((ja,), jidx, jb,
                                               jax.numpy.int32(n_valid),
                                               bound))
        assert int(got[0]) == int(want[0])
        k = min(int(want[0]), bound)
        np.testing.assert_array_equal(got[1].numpy()[:k], want[1][:k])
        np.testing.assert_array_equal(got[2].numpy()[:k], want[2][:k])
        np.testing.assert_array_equal(
            pr.groupby_cmat([pa], idx, pb, n_valid).numpy(),
            np.asarray(jr.groupby_cmat((ja,), jidx, jb,
                                       jax.numpy.int32(n_valid))))
