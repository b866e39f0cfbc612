"""Bidirectional graph-ordinal <-> document-id mapping.

Device-side counterpart of `GraphNodeIdToDocMap` (GraphNodeIdToDocMap.java:
17-23, 39-60, 119-141, 169-177): vectors live in a dense ordinal space while
documents live in a sparse, delete-prone doc-id space; the map must survive
sorting (update with a sort map at flush) and merges (reconstruction from
per-segment doc maps), with -1 meaning deleted / no vector.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DocMap:
    """ord_to_doc[i] = doc id for graph ordinal i (-1 = hole/deleted).

    `ord_to_parent` supports nested documents (parity with the reference's
    nested-field path, index/query/lucenelib + nested iterators): child
    vectors carry their parent doc id; queries aggregate child hits to
    parents unless expand_nested_docs is set.
    """

    ord_to_doc: np.ndarray  # int64 [num_ordinals]
    ord_to_parent: np.ndarray | None = None  # int64 [num_ordinals], -1=root

    def __post_init__(self):
        self.ord_to_doc = np.asarray(self.ord_to_doc, np.int64)
        if self.ord_to_parent is not None:
            self.ord_to_parent = np.asarray(self.ord_to_parent, np.int64)

    def lookup_parents(self, docs: np.ndarray) -> np.ndarray:
        """doc ids -> parent ids (-1 where the doc is not nested)."""
        if self.ord_to_parent is None:
            return np.full_like(np.asarray(docs, np.int64), -1)
        inv = {int(d): int(p) for d, p in
               zip(self.ord_to_doc, self.ord_to_parent) if d >= 0}
        flat = np.asarray(docs, np.int64).reshape(-1)
        out = np.asarray([inv.get(int(d), -1) for d in flat], np.int64)
        return out.reshape(np.asarray(docs).shape)

    @property
    def num_ordinals(self) -> int:
        return int(self.ord_to_doc.shape[0])

    def doc_to_ord(self, max_doc: int | None = None) -> np.ndarray:
        """Inverse map doc->ordinal (-1 where a doc has no vector)."""
        if max_doc is None:
            max_doc = int(self.ord_to_doc.max(initial=-1)) + 1
        inv = np.full((max_doc,), -1, np.int64)
        mask = self.ord_to_doc >= 0
        inv[self.ord_to_doc[mask]] = np.nonzero(mask)[0]
        return inv

    def lookup_docs(self, ords: np.ndarray) -> np.ndarray:
        """Vectorized ordinal->doc (-1 passes through)."""
        out = np.where(ords >= 0, self.ord_to_doc[np.clip(ords, 0, None)], -1)
        return out

    def apply_sort(self, old_to_new_doc: np.ndarray) -> "DocMap":
        """Re-map doc ids after an index sort (update(Sorter.DocMap) parity)."""
        mask = self.ord_to_doc >= 0
        new = self.ord_to_doc.copy()
        new[mask] = old_to_new_doc[self.ord_to_doc[mask]]
        parents = None
        if self.ord_to_parent is not None:
            parents = self.ord_to_parent.copy()
            pm = parents >= 0
            parents[pm] = old_to_new_doc[self.ord_to_parent[pm]]
        return DocMap(new, parents)

    def mark_deleted_docs(self, deleted_docs: np.ndarray) -> np.ndarray:
        """Ordinals whose doc is deleted (to tombstone in the graph).

        Deleted ids outside this segment's doc range belong to other
        segments and are ignored.
        """
        deleted_docs = np.asarray(deleted_docs, np.int64)
        size = int(self.ord_to_doc.max(initial=-1)) + 1
        dset = np.zeros(size, bool)
        dset[deleted_docs[(deleted_docs >= 0) & (deleted_docs < size)]] = True
        mask = (self.ord_to_doc >= 0) & dset[np.clip(self.ord_to_doc, 0, None)]
        return np.nonzero(mask)[0]

    @staticmethod
    def concat(maps: list["DocMap"], doc_bases: list[int]) -> "DocMap":
        """Merge per-segment maps with doc-id rebasing (merge reconstruction)."""
        parts, parent_parts = [], []
        for m, base in zip(maps, doc_bases):
            p = m.ord_to_doc.copy()
            p[p >= 0] += base
            parts.append(p)
            if m.ord_to_parent is not None:
                q = m.ord_to_parent.copy()
                q[q >= 0] += base
                parent_parts.append(q)
            else:
                parent_parts.append(np.full(p.shape[0], -1, np.int64))
        if not parts:
            return DocMap(np.empty(0, np.int64))
        parents = np.concatenate(parent_parts)
        return DocMap(
            np.concatenate(parts),
            parents if (parents >= 0).any() else None,
        )
