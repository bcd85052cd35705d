"""Key translation across a cluster: one primary mints every id.

Port of pilosa_tpu/utils/cluster_translate.py (the reference's
translate.go:359-433): the coordinator is the translation primary, so a
key maps to the same id on every node, which matters because raw ids
cross nodes (TopN's phase-2 id lists, replicated writes). Another node

  * translates from its own store when it can,
  * forwards a miss to the primary (POST /internal/translate/keys, with
    the caller's create flag: a read mints nothing there either) and
    installs the answer with TranslateStore.ensure_mapping,
  * on a reverse-lookup miss tails the primary's log from its own log
    size (GET /internal/translate/data) and retries, which leaves its
    `.keys` log byte-identical to the primary's.

A primary that cannot be reached answers a forward as a miss (None), as
the JAX package does: a read of the key counts nothing, and a write or
an import of it fails (the executor's and the API's checks) rather than
being acknowledged with nothing written.
"""

from __future__ import annotations

from typing import Optional

from pilosa_tpu_torch.net.client import ClientError
from pilosa_tpu_torch.utils.translate import (
    KIND_COLUMN,
    KIND_ROW,
    TranslateStore,
)


class ClusterTranslator:
    def __init__(self, store: TranslateStore, cluster, client):
        self.store = store
        self.cluster = cluster
        self.client = client

    # -- the primary --------------------------------------------------------

    def _primary_uri(self) -> Optional[str]:
        if self.cluster is None or self.cluster.is_coordinator():
            return None
        node = self.cluster.node_by_id(self.cluster.coordinator_id)
        return node.uri if node is not None and node.uri else None

    def _forward(self, index: str, field, keys: list, create: bool = True):
        uri = self._primary_uri()
        if uri is None:
            return None
        try:
            return self.client.translate_keys(uri, index, field, keys,
                                              create=create)
        except ClientError:
            return None

    def sync(self) -> bool:
        """Tail the primary's log from this node's log size; True when
        anything new arrived."""
        uri = self._primary_uri()
        if uri is None:
            return False
        try:
            data = self.client.translate_data(uri,
                                              offset=self.store.log_size())
        except ClientError:
            return False
        if data:
            self.store.apply_log(data)
        return bool(data)

    # -- forward translation ------------------------------------------------

    def _translate_one(self, kind: int, index: str, field: Optional[str],
                       key: str, create: bool) -> Optional[int]:
        local = (self.store.translate_column(index, key, create=False)
                 if kind == KIND_COLUMN else
                 self.store.translate_row(index, field, key, create=False))
        if local is not None:
            return local
        if self._primary_uri() is None:
            # the primary (or a single node) mints locally
            if kind == KIND_COLUMN:
                return self.store.translate_column(index, key, create=create)
            return self.store.translate_row(index, field, key, create=create)
        ids = self._forward(index, field, [key], create=create)
        if not ids or ids[0] is None:
            return None
        self.store.ensure_mapping(kind, index, field or "", key, ids[0])
        return ids[0]

    def _translate_many(self, index: str, field: Optional[str], keys: list,
                        create: bool) -> list:
        """Local hits first, then every miss in one RPC to the primary;
        the primary mints a batch in one log write."""
        kind = KIND_COLUMN if field is None else KIND_ROW
        if self._primary_uri() is None:
            if field is None:
                return self.store.translate_columns(index, keys,
                                                    create=create)
            return self.store.translate_rows(index, field, keys,
                                             create=create)
        out = (self.store.translate_columns(index, keys, create=False)
               if field is None else
               self.store.translate_rows(index, field, keys, create=False))
        missing = [i for i, v in enumerate(out) if v is None]
        if missing:
            got = self._forward(index, field, [keys[i] for i in missing],
                                create=create)
            for i, id_ in zip(missing, got or []):
                if id_ is not None:
                    self.store.ensure_mapping(kind, index, field or "",
                                              keys[i], id_)
                    out[i] = id_
        return out

    def translate_column(self, index: str, key: str,
                         create: bool = True) -> Optional[int]:
        return self._translate_one(KIND_COLUMN, index, None, key, create)

    def translate_columns(self, index: str, keys: list,
                          create: bool = True) -> list:
        return self._translate_many(index, None, keys, create)

    def translate_row(self, index: str, field: str, key: str,
                      create: bool = True) -> Optional[int]:
        return self._translate_one(KIND_ROW, index, field, key, create)

    def translate_rows(self, index: str, field: str, keys: list,
                       create: bool = True) -> list:
        return self._translate_many(index, field, keys, create)

    # -- reverse translation ------------------------------------------------

    def translate_column_to_string(self, index: str,
                                   id_: int) -> Optional[str]:
        out = self.store.translate_column_to_string(index, id_)
        if out is None and self.sync():
            out = self.store.translate_column_to_string(index, id_)
        return out

    def translate_columns_to_strings(self, index: str, ids) -> list:
        out = self.store.translate_columns_to_strings(index, ids)
        if any(k is None for k in out) and self.sync():
            out = self.store.translate_columns_to_strings(index, ids)
        return out

    def translate_row_to_string(self, index: str, field: str,
                                id_: int) -> Optional[str]:
        out = self.store.translate_row_to_string(index, field, id_)
        if out is None and self.sync():
            out = self.store.translate_row_to_string(index, field, id_)
        return out

    def log_bytes(self, offset: int = 0) -> bytes:
        return self.store.log_bytes(offset)
