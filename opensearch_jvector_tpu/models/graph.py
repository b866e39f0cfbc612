"""Vamana graph data model (device-resident, static shapes).

Replaces jVector's `OnHeapGraphIndex` / `OnDiskGraphIndex` pair with a single
dense representation designed for XLA:

  adjacency : int32 [capacity, max_degree]   (-1 padded neighbor lists)
  degrees   : int32 [capacity]
  live      : bool  [capacity]               (False = deleted / hole)
  entry     : int32 scalar                   (medoid ordinal)

Unlike the reference — which juggles four ordinal spaces during merge
(JVectorWriter.java:728-735) — node ids here are a single stable ordinal
space per segment with tombstones (`live`) and an explicit compaction pass
(see index/merge.py). `capacity >= size` leaves headroom for delta inserts
(the incremental-merge path, JVectorWriter.java:1166-1341).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def bucket_capacity(n: int, minimum: int = 64) -> int:
    """Graph capacity for n ordinals: next power of two (min `minimum`).

    Every distinct capacity is a distinct XLA program family (shapes are
    static under jit) and a fresh trace costs seconds; pow2 bucketing keeps
    the family count logarithmic in corpus size. The padded tail rows are
    live=False holes — the same representation deletes already use — so no
    search/build semantics change. (Disk files store only the used prefix;
    see index/segment.py.)
    """
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_rows(arr: jax.Array, capacity: int):
    """Zero-pad a row-indexed device array to `capacity` rows."""
    n = arr.shape[0]
    if n >= capacity:
        return arr
    widths = [(0, capacity - n)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, widths)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class VamanaGraph:
    """Device-resident Vamana graph state (a pytree).

    `upper_adjacency` is the optional hierarchy layer (hierarchy_enabled,
    HNSW-style): a sparse coarse graph over a sampled subset of nodes, in
    the SAME ordinal space (rows of non-members are -1). A query first
    descends the upper layer to pick a good base-layer entry point.
    """

    adjacency: jax.Array  # int32 [capacity, max_degree], -1 padded
    degrees: jax.Array  # int32 [capacity]
    live: jax.Array  # bool [capacity]
    entry: jax.Array  # int32 scalar
    upper_adjacency: jax.Array | None = None  # int32 [capacity, m_up] | None

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adjacency.shape[1]

    def size(self) -> int:
        """Number of live nodes (host sync)."""
        return int(jnp.sum(self.live))

    def id_upper_bound(self) -> int:
        """1 + highest ordinal ever assigned (mirrors getIdUpperBound)."""
        deg_used = np.asarray(self.live)
        nz = np.nonzero(deg_used)[0]
        return int(nz[-1]) + 1 if nz.size else 0

    @staticmethod
    def flat(capacity: int, n_live: int) -> "VamanaGraph":
        """Graph-less ('flat' index_type) placeholder: no adjacency, every
        ordinal live. Flat segments always serve through the scan tier, so
        the graph structure is vestigial — degree-1 all-(-1) rows keep
        every shape invariant of the segment codec intact."""
        live = np.zeros((capacity,), bool)
        live[:n_live] = True
        return VamanaGraph(
            adjacency=jnp.full((capacity, 1), -1, jnp.int32),
            degrees=jnp.zeros((capacity,), jnp.int32),
            live=jnp.asarray(live),
            entry=jnp.int32(0),
        )

    @staticmethod
    def empty(capacity: int, max_degree: int) -> "VamanaGraph":
        return VamanaGraph(
            adjacency=jnp.full((capacity, max_degree), -1, jnp.int32),
            degrees=jnp.zeros((capacity,), jnp.int32),
            live=jnp.zeros((capacity,), bool),
            entry=jnp.int32(0),
        )

    def with_capacity(self, new_capacity: int) -> "VamanaGraph":
        """Grow (never shrink) capacity, preserving contents."""
        if new_capacity <= self.capacity:
            return self
        pad = new_capacity - self.capacity
        upper = None
        if self.upper_adjacency is not None:
            upper = jnp.concatenate(
                [self.upper_adjacency,
                 jnp.full((pad, self.upper_adjacency.shape[1]), -1, jnp.int32)]
            )
        return VamanaGraph(
            adjacency=jnp.concatenate(
                [self.adjacency, jnp.full((pad, self.max_degree), -1, jnp.int32)]
            ),
            degrees=jnp.concatenate([self.degrees, jnp.zeros((pad,), jnp.int32)]),
            live=jnp.concatenate([self.live, jnp.zeros((pad,), bool)]),
            entry=self.entry,
            upper_adjacency=upper,
        )
