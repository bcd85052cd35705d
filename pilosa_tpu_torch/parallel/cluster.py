"""Cluster: membership over a static node list, and shard placement.

Trimmed port of pilosa_tpu/parallel/cluster.py: Node (:39), and of
Cluster (:88) the membership a static cluster needs (set_static,
node_by_id, local_node, is_coordinator, adopt_coordinator and
elect_coordinator: an explicitly adopted coordinator is sticky, else the
lowest node id coordinates), the placement (partition, partition_nodes,
shard_nodes, owns_shard, shards_by_node, non_primary_replicas,
:287-325), and the liveness state (down_ids, draining_ids, is_down,
is_draining, is_unavailable, the cluster state), which nothing in the
port sets yet: without liveness probing every member is live, so a
replica that cannot be reached fails a write ("replica write failed")
and a read re-maps that node's shards onto the next replica, as a JAX
cluster does with probing off.

Left out until the port takes liveness and healing: ResizeJob,
plan_resize, add_node, node_join/node_leave and the topology file
(:55-86, :326-429), and mark_down/mark_up/mark_draining.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from pilosa_tpu_torch.constants import DEFAULT_PARTITION_N
from pilosa_tpu_torch.parallel.placement import JmpHasher
from pilosa_tpu_torch.parallel.placement import partition as partition_fn

# cluster states (cluster.go:44-48; RESIZING comes with resize)
STATE_STARTING = "STARTING"
STATE_DEGRADED = "DEGRADED"
STATE_NORMAL = "NORMAL"


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


class Cluster:
    """Placement and static membership; nodes are kept sorted by id (the
    ring order the jump hash indexes into)."""

    def __init__(self, local_id: str, partition_n: int = DEFAULT_PARTITION_N,
                 replica_n: int = 1, hasher=None):
        self.local_id = local_id
        self.partition_n = partition_n
        self.replica_n = max(replica_n, 1)
        self.hasher = hasher or JmpHasher()
        self.nodes: list[Node] = []
        self.state = STATE_STARTING
        self.coordinator_id: Optional[str] = None
        self._explicit_claim: Optional[str] = None
        # liveness marks: probe-dead peers and peers that announced a drain
        self.down_ids: set[str] = set()
        self.draining_ids: set[str] = set()

    # -- membership ---------------------------------------------------------

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
        self._recompute_liveness_state()

    def clear_draining(self, node_id: str) -> None:
        """The drained peer came back (or aborted its drain)."""
        if node_id not in self.draining_ids:
            return
        self.draining_ids.discard(node_id)
        n = self.node_by_id(node_id)
        if n is not None and n.state == "DRAINING":
            n.state = "READY"
        self._recompute_liveness_state()

    def mark_down(self, node_id: str) -> None:
        """A peer failed its liveness probes: route around it."""
        if node_id == self.local_id or node_id in self.down_ids:
            return
        self.down_ids.add(node_id)
        n = self.node_by_id(node_id)
        if n is not None:
            n.state = "DOWN"
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
        self._recompute_liveness_state()

    def _recompute_liveness_state(self) -> None:
        """determineClusterState (cluster.go:522-533)."""
        member_ids = {n.id for n in self.nodes}
        self.down_ids &= member_ids
        self.draining_ids &= member_ids
        unavailable = self.down_ids | self.draining_ids
        if not unavailable:
            self.state = STATE_NORMAL
        elif len(unavailable) < self.replica_n:
            self.state = STATE_DEGRADED
        else:
            self.state = STATE_STARTING

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
