"""Resize planning and the topology file, the port's against the JAX
package's.

The same node ids, replica counts and cluster-wide shard sets (made from
a seed) go into both Cluster classes: plan_resize's instructions for a
join and for a leave are equal, instruction for instruction; a leave
below the replica count removes the node and degrades, a leave with no
surviving replica is refused with the JAX text, abort_resize ends
RESIZING, complete_resize changes the membership once every node has
acknowledged, a probe's mark does not end RESIZING, and the .topology
file each package writes opens in the other.
"""

import numpy as np
import pytest

from pilosa_tpu.parallel import cluster as jc
from pilosa_tpu_torch.parallel import cluster as pc


def _schema(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {idx: {f: sorted(int(s) for s in np.unique(
        rng.integers(0, 300, int(rng.integers(1, 120)))))
        for f in ("f", "t", "v")} for idx in ("d", "keys")}


def _pair(ids, replicas: int, seed: int):
    schema = _schema(seed)
    out = []
    for mod in (pc, jc):
        c = mod.Cluster(ids[0], replica_n=replicas,
                        schema_fn=lambda s=schema: s)
        c.set_static([mod.Node(id=i, uri=f"http://h{i}:1") for i in ids])
        out.append(c)
    return out


def _plan(c, mod, event: str, node_id: str):
    job = c.plan_resize(event, mod.Node(id=node_id, uri="http://new:1"))
    return {t: [s.to_dict() for s in srcs]
            for t, srcs in job.instructions.items()}


@pytest.mark.parametrize("n_nodes,replicas", [(2, 1), (3, 2), (4, 2),
                                              (5, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_join_and_leave_equal_jax(n_nodes, replicas, seed):
    ids = [f"node{i}" for i in range(n_nodes)]
    port, jax = _pair(ids, replicas, seed)
    joined = _plan(port, pc, "join", "node9")
    assert joined == _plan(jax, jc, "join", "node9")
    assert joined["node9"], "the joiner fetches something"
    if replicas == 1:
        # a leave would lose the shards only the leaver holds
        for c, mod in ((port, pc), (jax, jc)):
            with pytest.raises(ValueError):
                _plan(c, mod, "leave", ids[1])
        return
    left = _plan(port, pc, "leave", ids[1])
    assert left == _plan(jax, jc, "leave", ids[1])
    assert ids[1] not in left
    moved = sum(len(v) for v in left.values())
    assert moved > 0
    for srcs in left.values():
        assert all(s["fromNode"] != ids[1] for s in srcs)


@pytest.mark.parametrize("mod", [pc, jc], ids=["port", "jax"])
def test_leave_below_replicas_degrades(mod):
    c = mod.Cluster("a", replica_n=2, schema_fn=lambda: {"d": {"f": [0]}})
    c.set_static([mod.Node(id="a"), mod.Node(id="b")])
    assert c.node_leave("b") is None
    assert [n.id for n in c.nodes] == ["a"]
    assert c.state == mod.STATE_DEGRADED and c.active_job is None


@pytest.mark.parametrize("mod", [pc, jc], ids=["port", "jax"])
def test_leave_without_a_surviving_replica_is_refused(mod):
    c = mod.Cluster("a", replica_n=1,
                    schema_fn=lambda: {"d": {"f": list(range(64))}})
    c.set_static([mod.Node(id="a"), mod.Node(id="b")])
    with pytest.raises(ValueError) as e:
        c.node_leave("b")
    assert str(e.value) == ("not enough data to perform resize (replica "
                            "factor may need to be increased)")


@pytest.mark.parametrize("mod", [pc, jc], ids=["port", "jax"])
def test_job_abort_and_completion(mod, tmp_path):
    c = mod.Cluster("a", replica_n=2,
                    schema_fn=lambda: {"d": {"f": list(range(32))}},
                    topology_path=str(tmp_path / ".topology"))
    c.set_static([mod.Node(id=i) for i in "abc"])
    seen = []
    c.on_state_change = seen.append
    job = c.node_join(mod.Node(id="d", uri="http://d:1"))
    assert c.state == mod.STATE_RESIZING and c.active_job is job
    # a probe's mark waits for the job's end
    c.mark_down("b")
    assert c.state == mod.STATE_RESIZING
    c.mark_up("b")
    c.abort_resize()
    assert c.state == mod.STATE_NORMAL and c.active_job is None
    assert [n.id for n in c.nodes] == ["a", "b", "c"]
    job = c.node_join(mod.Node(id="d", uri="http://d:1"))
    for nid in sorted(job.instructions)[:-1]:
        c.complete_resize(job, nid)
        assert c.state == mod.STATE_RESIZING
    c.complete_resize(job, sorted(job.instructions)[-1])
    assert [n.id for n in c.nodes] == ["a", "b", "c", "d"]
    assert c.node_by_id("d").uri == "http://d:1"
    assert c.state == mod.STATE_NORMAL and c.active_job is None
    assert seen == ["RESIZING", "NORMAL", "RESIZING", "NORMAL"]
    assert c.load_topology() == ["a", "b", "c", "d"]


@pytest.mark.parametrize("writer,reader", [(pc, jc), (jc, pc)],
                         ids=["port-to-jax", "jax-to-port"])
def test_topology_file_opens_in_either_package(tmp_path, writer, reader):
    path = str(tmp_path / ".topology")
    w = writer.Cluster("a", topology_path=path)
    w.add_node(writer.Node(id="b"))
    w.add_node(writer.Node(id="a"))
    w.remove_node("b")
    w.add_node(writer.Node(id="c"))
    r = reader.Cluster("a", topology_path=path)
    assert r.load_topology() == ["a", "c"]
    assert r.cluster_id == w.cluster_id
    with open(path) as f:
        written = f.read()
    r.nodes = [reader.Node(id="a"), reader.Node(id="c")]
    r.save_topology()
    with open(path) as f:
        assert f.read() == written
