"""Container stores for `Bitmap`.

Copy of pilosa_tpu/storage/containers.py. A Bitmap keeps its key ->
Container map in a store: a plain ``dict`` (the default), or
``BTreeContainers``, a leaf-linked B+Tree of order 64 keyed by the 48-bit
container key (the reference's enterprise/b store), whose keys iterate in
sorted order and whose nodes bound memory on very sparse key spaces.
(The frozen array-backed store of storage/frozen.py is the third, made
only by bulk loads and large parses.) The store is picked per Bitmap with
``store=`` or process-wide with ``PILOSA_TPU_CONTAINER_STORE=btree``;
derived bitmaps inherit their source's kind, and the serialized bytes are
the same whichever store holds the containers.
"""

from __future__ import annotations

import os
from bisect import bisect_left, bisect_right
from collections.abc import MutableMapping
from typing import Any, Iterator, Optional

# max keys per node before a split; the reference's b package uses 2x=64
# values per data page (enterprise/b/btree.go kd/kx consts)
_ORDER = 64


class _Leaf:
    __slots__ = ("keys", "vals", "next")

    def __init__(self) -> None:
        self.keys: list[int] = []
        self.vals: list[Any] = []
        self.next: Optional[_Leaf] = None


class _Inner:
    __slots__ = ("keys", "children")

    def __init__(self) -> None:
        # children[i] holds keys k with keys[i-1] <= k < keys[i]
        # (keys has len(children) - 1 separators)
        self.keys: list[int] = []
        self.children: list[Any] = []


class BTreeContainers(MutableMapping):
    """Leaf-linked B+Tree mapping int keys → containers.

    Deletion removes the key from its leaf; nodes that empty out are
    unlinked from their parents (cascading), but non-empty underfull nodes
    are not rebalanced — correct, and amortized fine for container-key
    workloads where keys churn within a bounded space.
    """

    def __init__(self, items=None) -> None:
        self._root: Any = _Leaf()
        self._len = 0
        if items is not None:
            # a mapping (dict registers as MutableMapping) or (k, v) pairs
            src = items.items() if isinstance(items, MutableMapping) else items
            for k, v in src:
                self[k] = v

    # -- search -------------------------------------------------------------

    def _find_leaf(self, key: int, path: Optional[list] = None) -> _Leaf:
        node = self._root
        while isinstance(node, _Inner):
            i = bisect_right(node.keys, key)
            if path is not None:
                path.append((node, i))
            node = node.children[i]
        return node

    def __getitem__(self, key: int) -> Any:
        leaf = self._find_leaf(key)
        i = bisect_left(leaf.keys, key)
        if i < len(leaf.keys) and leaf.keys[i] == key:
            return leaf.vals[i]
        raise KeyError(key)

    def __contains__(self, key: object) -> bool:
        # no isinstance gate: numpy integer keys must behave like ints,
        # exactly as they do under the dict store's hash equality
        try:
            leaf = self._find_leaf(key)  # type: ignore[arg-type]
            i = bisect_left(leaf.keys, key)
        except TypeError:
            return False
        return i < len(leaf.keys) and leaf.keys[i] == key

    # -- insert -------------------------------------------------------------

    def __setitem__(self, key: int, val: Any) -> None:
        path: list = []
        leaf = self._find_leaf(key, path)
        i = bisect_left(leaf.keys, key)
        if i < len(leaf.keys) and leaf.keys[i] == key:
            leaf.vals[i] = val
            return
        leaf.keys.insert(i, key)
        leaf.vals.insert(i, val)
        self._len += 1
        if len(leaf.keys) <= _ORDER:
            return
        # split the leaf; propagate splits up the recorded path
        mid = len(leaf.keys) // 2
        right = _Leaf()
        right.keys, right.vals = leaf.keys[mid:], leaf.vals[mid:]
        del leaf.keys[mid:], leaf.vals[mid:]
        right.next, leaf.next = leaf.next, right
        sep, new_child = right.keys[0], right
        while path:
            parent, ci = path.pop()
            parent.keys.insert(ci, sep)
            parent.children.insert(ci + 1, new_child)
            if len(parent.children) <= _ORDER:
                return
            mid = len(parent.keys) // 2
            sep = parent.keys[mid]
            rnode = _Inner()
            rnode.keys = parent.keys[mid + 1:]
            rnode.children = parent.children[mid + 1:]
            del parent.keys[mid:], parent.children[mid + 1:]
            new_child = rnode
            # loop continues: insert (sep, rnode) into the next parent;
            # when path is exhausted, parent IS the root and the tail below
            # grows a new root above it
        root = _Inner()
        root.keys = [sep]
        root.children = [self._root, new_child]
        self._root = root

    # -- delete -------------------------------------------------------------

    def __delitem__(self, key: int) -> None:
        path: list = []
        leaf = self._find_leaf(key, path)
        i = bisect_left(leaf.keys, key)
        if i >= len(leaf.keys) or leaf.keys[i] != key:
            raise KeyError(key)
        del leaf.keys[i], leaf.vals[i]
        self._len -= 1
        node: Any = leaf
        while not node.keys if isinstance(node, _Leaf) else not node.children:
            if not path:
                # emptied root: reset to a fresh leaf
                self._root = _Leaf()
                return
            parent, ci = path.pop()
            # unlink node from parent; fix the leaf chain via the recorded
            # descent path (O(depth), not a full chain walk)
            if isinstance(node, _Leaf):
                prev = self._prev_leaf_via_path(path, parent, ci)
                if prev is not None:
                    prev.next = node.next
            del parent.children[ci]
            if parent.keys:
                del parent.keys[min(ci, len(parent.keys) - 1)]
            node = parent
        # collapse single-child root chains
        while isinstance(self._root, _Inner) and len(self._root.children) == 1:
            self._root = self._root.children[0]

    @staticmethod
    def _prev_leaf_via_path(path: list, parent: _Inner,
                            ci: int) -> Optional[_Leaf]:
        """Left neighbor of parent.children[ci] in the leaf chain, found by
        walking down the rightmost spine of the left sibling subtree. The
        sibling comes from `parent` when ci > 0, else from the nearest
        ancestor on `path` with a left branch; None when children[ci] is the
        leftmost leaf of the tree."""
        if ci > 0:
            node: Any = parent.children[ci - 1]
        else:
            for anc, ai in reversed(path):
                if ai > 0:
                    node = anc.children[ai - 1]
                    break
            else:
                return None
        while isinstance(node, _Inner):
            node = node.children[-1]
        return node

    # -- iteration ----------------------------------------------------------

    def _first_leaf(self) -> _Leaf:
        node = self._root
        while isinstance(node, _Inner):
            node = node.children[0]
        return node

    def __iter__(self) -> Iterator[int]:
        leaf: Optional[_Leaf] = self._first_leaf()
        while leaf is not None:
            yield from leaf.keys
            leaf = leaf.next

    def items(self):
        """Re-iterable view walking the leaf chain — one linear pass per
        iteration, not a descent per key (the MutableMapping default would
        be O(n log n)), with dict-view semantics (re-iterable, len())."""
        return _LeafView(self, lambda leaf: zip(leaf.keys, leaf.vals))

    def values(self):
        return _LeafView(self, lambda leaf: iter(leaf.vals))

    def first_key(self) -> int:
        """Smallest key, O(depth). Raises ValueError when empty."""
        leaf = self._first_leaf()
        if not leaf.keys:
            raise ValueError("empty tree")
        return leaf.keys[0]

    def last_key(self) -> int:
        """Largest key, O(depth). Raises ValueError when empty."""
        node = self._root
        while isinstance(node, _Inner):
            node = node.children[-1]
        if not node.keys:
            raise ValueError("empty tree")
        return node.keys[-1]

    def __len__(self) -> int:
        return self._len

    def irange(self, lo: int, hi: int) -> Iterator[int]:
        """Keys in [lo, hi], in order, touching O(log n + k) entries —
        what the B+Tree buys over the dict store's full-sort."""
        leaf = self._find_leaf(lo)
        i = bisect_left(leaf.keys, lo)
        cur: Optional[_Leaf] = leaf
        while cur is not None:
            while i < len(cur.keys):
                k = cur.keys[i]
                if k > hi:
                    return
                yield k
                i += 1
            cur, i = cur.next, 0


class _LeafView:
    """Dict-view-shaped wrapper over a leaf-chain walk: re-iterable + len()."""

    def __init__(self, tree: "BTreeContainers", per_leaf) -> None:
        self._tree = tree
        self._per_leaf = per_leaf

    def __iter__(self):
        leaf: Optional[_Leaf] = self._tree._first_leaf()
        while leaf is not None:
            yield from self._per_leaf(leaf)
            leaf = leaf.next

    def __len__(self) -> int:
        return len(self._tree)


def resolve_store_kind(kind: Optional[str]) -> str:
    """None → the PILOSA_TPU_CONTAINER_STORE env (the build-tag analog),
    default "dict". Single source of truth for the env name + default."""
    return kind or os.environ.get("PILOSA_TPU_CONTAINER_STORE", "dict")


def make_container_store(kind: Optional[str] = None):
    """Store factory (the `NewFileBitmap` hook analog). kind: "dict" |
    "btree" | None (None → resolve_store_kind)."""
    kind = resolve_store_kind(kind)
    if kind == "btree":
        return BTreeContainers()
    if kind == "dict":
        return {}
    raise ValueError(f"unknown container store: {kind!r}")
