"""Cluster: membership, shard placement, liveness and resize planning.

Port of pilosa_tpu/parallel/cluster.py: Node (:39), ResizeSource and
ResizeJob (:55-86), and Cluster (:88): membership (add_node, remove_node,
set_static, node_by_id, local_node, is_coordinator, adopt_coordinator and
elect_coordinator: an explicitly adopted coordinator is sticky, else the
lowest node id coordinates), the liveness marks (down_ids, draining_ids,
mark_down/mark_up, mark_draining/clear_draining) and the cluster state
they give (determineClusterState; a probe's mark never ends RESIZING,
only the job's end does), the placement (partition, partition_nodes,
shard_nodes, owns_shard, shards_by_node, non_primary_replicas,
:287-325), resize planning (plan_resize, the fragSources diff over the
cluster-wide available shards that schema_fn gives; node_join,
node_leave, complete_resize, abort_resize, :326-408) and the topology
file (save_topology, load_topology, :410-429): <data_dir>/.topology, the
JAX package's JSON, so either package opens the other's.
"""

from __future__ import annotations

import json
import os
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from pilosa_tpu_torch.constants import DEFAULT_PARTITION_N
from pilosa_tpu_torch.parallel.placement import JmpHasher
from pilosa_tpu_torch.parallel.placement import partition as partition_fn

# cluster states (cluster.go:44-48)
STATE_STARTING = "STARTING"
STATE_DEGRADED = "DEGRADED"
STATE_NORMAL = "NORMAL"
STATE_RESIZING = "RESIZING"

# node events (event.go)
EVENT_JOIN = "join"
EVENT_LEAVE = "leave"
EVENT_UPDATE = "update"


@dataclass
class Node:
    id: str
    uri: str = ""
    is_coordinator: bool = False
    state: str = "READY"

    def to_dict(self) -> dict:
        return {"id": self.id, "uri": self.uri,
                "isCoordinator": self.is_coordinator}

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(id=d["id"], uri=d.get("uri", ""),
                   is_coordinator=d.get("isCoordinator", False))


@dataclass
class ResizeSource:
    """One fragment-copy instruction: the follower asks the donor which
    views it holds for the shard and copies each."""
    index: str
    field: str
    shard: int
    from_node: str

    def to_dict(self) -> dict:
        return {"index": self.index, "field": self.field,
                "shard": self.shard, "fromNode": self.from_node}


@dataclass
class ResizeJob:
    """The coordinator's plan for one node's join or leave."""
    id: str
    event: str  # join | leave
    node_id: str
    # the joining or leaving node, with its URI
    node: Optional[Node] = None
    # target node id -> the fragment sources it fetches
    instructions: dict[str, list[ResizeSource]] = field(default_factory=dict)
    completed: set = field(default_factory=set)

    def done(self) -> bool:
        return set(self.instructions) <= self.completed


class Cluster:
    """Placement, membership and resize planning; nodes are kept sorted by
    id (the ring order the jump hash indexes into). schema_fn() gives
    {index: {field: [shards]}} over the cluster-wide available shards (a
    shard may live only on peers); topology_path is the .topology file."""

    def __init__(self, local_id: str, partition_n: int = DEFAULT_PARTITION_N,
                 replica_n: int = 1, hasher=None,
                 schema_fn: Optional[Callable[[], dict]] = None,
                 topology_path: Optional[str] = None):
        self.local_id = local_id
        self.partition_n = partition_n
        self.replica_n = max(replica_n, 1)
        self.hasher = hasher or JmpHasher()
        self.nodes: list[Node] = []
        self.state = STATE_STARTING
        self.coordinator_id: Optional[str] = None
        self._explicit_claim: Optional[str] = None
        self.schema_fn = schema_fn or (lambda: {})
        self.topology_path = topology_path
        self.cluster_id = str(uuid.uuid4())
        self.on_state_change: Optional[Callable[[str], None]] = None
        self.active_job: Optional[ResizeJob] = None
        # liveness marks: probe-dead peers and peers that announced a drain
        self.down_ids: set[str] = set()
        self.draining_ids: set[str] = set()

    # -- membership ---------------------------------------------------------

    def add_node(self, node: Node) -> None:
        """Insert keeping the id order; a pending explicit coordinator
        claim takes effect if this is the claimed node."""
        if self.node_by_id(node.id) is None:
            self.nodes.append(node)
            self.nodes.sort(key=lambda n: n.id)
            self.elect_coordinator()
        self.save_topology()

    def remove_node(self, node_id: str) -> None:
        self.nodes = [n for n in self.nodes if n.id != node_id]
        if self._explicit_claim == node_id:
            # an explicit removal retires the claim for good
            self._explicit_claim = None
        self.elect_coordinator()
        self.save_topology()

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return next((n for n in self.nodes if n.id == node_id), None)

    @property
    def local_node(self) -> Optional[Node]:
        return self.node_by_id(self.local_id)

    def is_coordinator(self) -> bool:
        return self.coordinator_id == self.local_id

    def adopt_coordinator(self, node_id: str) -> None:
        """An explicit adoption: sticky while the node is (or becomes) a
        member."""
        self._explicit_claim = node_id
        self.elect_coordinator()

    def elect_coordinator(self) -> None:
        """The adopted coordinator while it is a member, else the lowest
        node id."""
        ids = {n.id for n in self.nodes}
        claim = self._explicit_claim
        if claim is not None and claim in ids:
            self.coordinator_id = claim
            return
        self.coordinator_id = min(ids) if ids else self.local_id

    def set_static(self, nodes: list[Node]) -> None:
        """Fixed membership (cluster.go:1939 setStatic)."""
        self.nodes = sorted(nodes, key=lambda n: n.id)
        if self.nodes:
            self.coordinator_id = self.coordinator_id or self.nodes[0].id
        self._recompute_liveness_state()

    def _set_state(self, state: str) -> None:
        if state != self.state:
            self.state = state
            if self.on_state_change is not None:
                self.on_state_change(state)

    # -- liveness -----------------------------------------------------------

    def is_down(self, node_id: str) -> bool:
        return node_id in self.down_ids

    def is_draining(self, node_id: str) -> bool:
        return node_id in self.draining_ids

    def is_unavailable(self, node_id: str) -> bool:
        """Down or draining: what every routing decision reads."""
        return node_id in self.down_ids or node_id in self.draining_ids

    def mark_draining(self, node_id: str) -> None:
        """A peer announced a graceful drain: route around it now."""
        if node_id == self.local_id or node_id in self.draining_ids:
            return
        self.draining_ids.add(node_id)
        n = self.node_by_id(node_id)
        if n is not None and n.state != "DOWN":
            n.state = "DRAINING"
        if self.state != STATE_RESIZING:
            self._recompute_liveness_state()

    def clear_draining(self, node_id: str) -> None:
        """The drained peer came back (or aborted its drain)."""
        if node_id not in self.draining_ids:
            return
        self.draining_ids.discard(node_id)
        n = self.node_by_id(node_id)
        if n is not None and n.state == "DRAINING":
            n.state = "READY"
        if self.state != STATE_RESIZING:
            self._recompute_liveness_state()

    def mark_down(self, node_id: str) -> None:
        """A peer failed its liveness probes: route around it."""
        if node_id == self.local_id or node_id in self.down_ids:
            return
        self.down_ids.add(node_id)
        n = self.node_by_id(node_id)
        if n is not None:
            n.state = "DOWN"
        if self.state != STATE_RESIZING:
            self._recompute_liveness_state()

    def mark_up(self, node_id: str) -> None:
        """A down (or draining) peer answers again; it is neither."""
        if node_id not in self.down_ids and node_id not in self.draining_ids:
            return
        self.down_ids.discard(node_id)
        self.draining_ids.discard(node_id)
        n = self.node_by_id(node_id)
        if n is not None:
            n.state = "READY"
        if self.state != STATE_RESIZING:
            self._recompute_liveness_state()

    def _recompute_liveness_state(self) -> None:
        """determineClusterState (cluster.go:522-533): fewer unavailable
        nodes than replica_n is DEGRADED, as many is STARTING. The marks
        defer to a RESIZING window; a membership replacement (set_static,
        a job's end) recomputes whatever the state, which is what ends
        RESIZING."""
        member_ids = {n.id for n in self.nodes}
        self.down_ids &= member_ids
        self.draining_ids &= member_ids
        unavailable = self.down_ids | self.draining_ids
        if not unavailable:
            self._set_state(STATE_NORMAL)
        elif len(unavailable) < self.replica_n:
            self._set_state(STATE_DEGRADED)
        else:
            self._set_state(STATE_STARTING)

    # -- placement ----------------------------------------------------------

    def partition(self, index: str, shard: int) -> int:
        return partition_fn(index, shard, self.partition_n)

    def partition_nodes(self, partition_id: int) -> list[Node]:
        """Primary and replicas around the ring (cluster.go:857-878)."""
        if not self.nodes:
            return []
        replica_n = min(self.replica_n, len(self.nodes))
        idx = self.hasher.hash(partition_id, len(self.nodes))
        return [self.nodes[(idx + i) % len(self.nodes)]
                for i in range(replica_n)]

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        return self.partition_nodes(self.partition(index, shard))

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def shards_by_node(self, index: str,
                       shards: list[int]) -> dict[str, list[int]]:
        """Shards grouped by their first live owner: the fan-out plan
        (executor.go:2163 shardsByNode). With every replica unavailable
        the primary keeps the shard, so the query fails on it rather than
        dropping it."""
        out: dict[str, list[int]] = {}
        for s in shards:
            nodes = self.shard_nodes(index, s)
            live = [n for n in nodes if not self.is_unavailable(n.id)]
            if live:
                out.setdefault(live[0].id, []).append(s)
            elif nodes:
                out.setdefault(nodes[0].id, []).append(s)
        return out

    def non_primary_replicas(self, index: str, shard: int) -> list[Node]:
        return self.shard_nodes(index, shard)[1:]

    # -- resize planning (fragSources, cluster.go:741-826) ------------------

    def plan_resize(self, event: str, node: Node) -> ResizeJob:
        """The ownership before and after a membership change, diffed: each
        node's fetch instructions for the fragments it newly owns, each
        from the lowest-id surviving old owner."""
        before = Cluster(self.local_id, self.partition_n, self.replica_n,
                         self.hasher)
        before.nodes = list(self.nodes)
        after = Cluster(self.local_id, self.partition_n, self.replica_n,
                        self.hasher)
        after.nodes = list(self.nodes)
        if event == EVENT_JOIN:
            after.nodes = sorted(after.nodes + [node], key=lambda n: n.id)
        elif event == EVENT_LEAVE:
            after.nodes = [n for n in after.nodes if n.id != node.id]
        else:
            raise ValueError(f"unsupported resize event: {event}")
        after_ids = {n.id for n in after.nodes}
        job = ResizeJob(id=str(uuid.uuid4()), event=event, node_id=node.id,
                        node=node)
        for index, fields in self.schema_fn().items():
            for fname, shards in fields.items():
                for shard in shards:
                    old = {n.id for n in before.shard_nodes(index, shard)}
                    new = {n.id for n in after.shard_nodes(index, shard)}
                    for target in new - old:
                        donors = [i for i in old if i in after_ids]
                        if not donors:
                            # a leave with no surviving replica would drop
                            # data (fragSources, cluster.go:806-811)
                            raise ValueError(
                                "not enough data to perform resize "
                                "(replica factor may need to be increased)")
                        job.instructions.setdefault(target, []).append(
                            ResizeSource(index, fname, shard,
                                         sorted(donors)[0]))
        for n in after.nodes:
            job.instructions.setdefault(n.id, [])
        return job

    def node_join(self, node: Node) -> Optional[ResizeJob]:
        """The coordinator's side of a join (nodeJoin, cluster.go:1715)."""
        if self.node_by_id(node.id) is not None:
            return None
        job = self.plan_resize(EVENT_JOIN, node)
        self.active_job = job
        self._set_state(STATE_RESIZING)
        return job

    def node_leave(self, node_id: str) -> Optional[ResizeJob]:
        """The coordinator's side of a leave; with no more nodes than
        replica_n the node just goes and the cluster serves DEGRADED
        (cluster.go:45)."""
        node = self.node_by_id(node_id)
        if node is None:
            return None
        if len(self.nodes) <= self.replica_n:
            self.remove_node(node_id)
            self._set_state(STATE_DEGRADED)
            return None
        job = self.plan_resize(EVENT_LEAVE, node)
        self.active_job = job
        self._set_state(STATE_RESIZING)
        return job

    def complete_resize(self, job: ResizeJob, node_id: str) -> None:
        """A node acknowledged its instruction; the last one ends the job
        (the membership changes and the state is recomputed)."""
        job.completed.add(node_id)
        if job.done():
            if job.event == EVENT_JOIN:
                if self.node_by_id(job.node_id) is None:
                    self.add_node(job.node or Node(id=job.node_id))
            else:
                self.remove_node(job.node_id)
            self.active_job = None
            self._recompute_liveness_state()

    def abort_resize(self) -> None:
        """api.ResizeAbort (api.go:1131)."""
        self.active_job = None
        self._recompute_liveness_state()

    # -- the topology file (cluster.go:1534-1646, JSON) ---------------------

    def save_topology(self) -> None:
        if not self.topology_path:
            return
        os.makedirs(os.path.dirname(self.topology_path), exist_ok=True)
        tmp = self.topology_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"clusterID": self.cluster_id,
                       "nodeIDs": [n.id for n in self.nodes]}, f)
        os.replace(tmp, self.topology_path)

    def load_topology(self) -> list[str]:
        if not self.topology_path or not os.path.exists(self.topology_path):
            return []
        with open(self.topology_path) as f:
            data = json.load(f)
        self.cluster_id = data.get("clusterID", self.cluster_id)
        return data.get("nodeIDs", [])
