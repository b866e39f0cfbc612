"""Jitted k-means++ / Lloyd clustering — the PQ codebook trainer.

Device replacement for the reference's `ProductQuantization.compute`
(k-means++ per subspace, UNWEIGHTED centroid updates, parallel pools —
call site JVectorIndexQuantization.java:114-140). Here the per-subspace
parallelism is a `vmap` and the per-point parallelism is batched matmuls;
no thread pools.

UNWEIGHTED == plain arithmetic-mean centroid update (no point weights).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opensearch_jvector_tpu.ops.distances import pairwise_sqdist


def _kmeanspp_init(x: jax.Array, k: int, key: jax.Array) -> jax.Array:
    """k-means++ seeding: [n, d] -> [k, d].

    Sequential by nature (each new seed depends on current min distances);
    the O(n) distance update per step is the vectorized part.
    """
    n = x.shape[0]

    k0, key = jax.random.split(key)
    first = x[jax.random.randint(k0, (), 0, n)]
    centroids0 = jnp.zeros((k, x.shape[1]), x.dtype).at[0].set(first)
    mind0 = pairwise_sqdist(first[None, :], x)[0]

    def step(i, state):
        centroids, mind, key = state
        key, sub = jax.random.split(key)
        # Sample proportional to min squared distance (Gumbel-max on logs).
        logits = jnp.log(jnp.maximum(mind, 1e-30))
        g = jax.random.gumbel(sub, (n,), dtype=logits.dtype)
        idx = jnp.argmax(logits + g)
        c = x[idx]
        centroids = centroids.at[i].set(c)
        mind = jnp.minimum(mind, pairwise_sqdist(c[None, :], x)[0])
        return centroids, mind, key

    centroids, _, _ = jax.lax.fori_loop(1, k, step, (centroids0, mind0, key))
    return centroids


def _lloyd_iter(x: jax.Array, centroids: jax.Array) -> jax.Array:
    """One Lloyd step: assign to nearest centroid, recompute means.

    Centroid update as one-hot matmul so the reduction is one matmul.
    Empty clusters keep their previous centroid.
    """
    k = centroids.shape[0]
    d2 = pairwise_sqdist(x, centroids)  # [n, k]
    assign = jnp.argmin(d2, axis=1)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # [n, k]
    sums = jax.lax.dot_general(
        onehot,
        x.astype(jnp.float32),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [k, d]
    counts = jnp.sum(onehot, axis=0)  # [k]
    means = sums / jnp.maximum(counts, 1.0)[:, None]
    return jnp.where((counts > 0)[:, None], means, centroids).astype(x.dtype)


def _train_one(x: jax.Array, k: int, iters: int, key: jax.Array) -> jax.Array:
    centroids = _kmeanspp_init(x, k, key)
    return jax.lax.fori_loop(0, iters, lambda _, c: _lloyd_iter(x, c), centroids)


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def train_kmeans(
    x: jax.Array, k: int, iters: int = 8, key: jax.Array | None = None
) -> jax.Array:
    """Train k centroids over x [n, d] -> [k, d] (k-means++ init + Lloyd)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    return _train_one(x, k, iters, key)


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def train_kmeans_subspaces(
    x_sub: jax.Array, k: int, iters: int = 8, key: jax.Array | None = None
) -> jax.Array:
    """Per-subspace codebook training: [M, n, dsub] -> [M, k, dsub].

    The per-subspace parallelism of the reference's pool-submitted training
    becomes a vmap over the leading axis.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, x_sub.shape[0])
    return jax.vmap(lambda xs, kk: _train_one(xs, k, iters, kk))(x_sub, keys)


# ---------------------------------------------------------------------------
# Anisotropic (score-aware) clustering — ScaNN-style loss (Guo et al. 2020,
# "Accelerating Large-Scale Inference with Anisotropic Vector Quantization"):
# quantization error PARALLEL to the data point hurts inner-product ranking
# more than the orthogonal error, so the loss weights it by eta > 1:
#   loss(c; x) = ||c - x||^2 + (eta - 1) * ((c - x) . v)^2,   v = x/||x||
# Assignment uses this loss; the centroid update solves the per-cluster
# normal equations  [N I + (eta-1) S] c = sum x + (eta-1) sum v (v.x),
# S = sum v v^T  (dsub x dsub, batched jnp.linalg.solve).
# ---------------------------------------------------------------------------


def aniso_assign_scores(
    x: jax.Array, centroids: jax.Array, eta: jax.Array
) -> jax.Array:
    """Anisotropic assignment cost [n, k] (lower = better)."""
    d2 = pairwise_sqdist(x, centroids)  # [n, k]
    nrm = jnp.sqrt(jnp.sum(x * x, axis=-1))  # [n]
    v = x / jnp.maximum(nrm, 1e-30)[:, None]  # unit directions
    proj = jax.lax.dot_general(
        v, centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [n, k] = c . v
    par = proj - nrm[:, None]  # (c - x) . v
    return d2 + (eta - 1.0) * par * par


def _lloyd_iter_aniso(x: jax.Array, centroids: jax.Array,
                      eta: jax.Array) -> jax.Array:
    """One anisotropic Lloyd step (weighted assignment + exact WLS update)."""
    k, dsub = centroids.shape
    assign = jnp.argmin(aniso_assign_scores(x, centroids, eta), axis=1)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # [n, k]
    nrm = jnp.sqrt(jnp.sum(x * x, axis=-1))
    v = x / jnp.maximum(nrm, 1e-30)[:, None]
    counts = jnp.sum(onehot, axis=0)  # [k]
    sum_x = jax.lax.dot_general(
        onehot, x.astype(jnp.float32), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [k, dsub]
    # rhs extra term: sum_i v_i (v_i . x_i) = sum_i v_i ||x_i||
    vn = v * nrm[:, None]
    sum_vn = jax.lax.dot_general(
        onehot, vn.astype(jnp.float32), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # [k, dsub]
    # scatter matrices S_k = sum_i v_i v_i^T per cluster: einsum over the
    # one-hot mask ([n,k],[n,a],[n,b] -> [k,a,b])
    s = jnp.einsum("nk,na,nb->kab", onehot, v, v,
                   preferred_element_type=jnp.float32)
    lhs = (counts[:, None, None] * jnp.eye(dsub, dtype=jnp.float32)[None]
           + (eta - 1.0) * s)
    rhs = sum_x + (eta - 1.0) * sum_vn
    # empty clusters: identity system keeps the previous centroid
    safe_lhs = jnp.where(
        (counts > 0)[:, None, None], lhs,
        jnp.eye(dsub, dtype=jnp.float32)[None],
    )
    safe_rhs = jnp.where((counts > 0)[:, None], rhs,
                         centroids.astype(jnp.float32))
    new = jnp.linalg.solve(safe_lhs, safe_rhs[..., None])[..., 0]
    return new.astype(x.dtype)


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def train_kmeans_subspaces_aniso(
    x_sub: jax.Array, k: int, eta: float, iters: int = 8,
    key: jax.Array | None = None,
) -> jax.Array:
    """Anisotropic per-subspace training: [M, n, dsub] -> [M, k, dsub].

    Seeds with plain k-means++ (the loss difference only matters once
    clusters form), then runs anisotropic Lloyd iterations."""
    if key is None:
        key = jax.random.PRNGKey(0)
    eta = jnp.float32(eta)
    keys = jax.random.split(key, x_sub.shape[0])

    def one(xs, kk):
        c0 = _kmeanspp_init(xs, k, kk)
        return jax.lax.fori_loop(
            0, iters, lambda _, c: _lloyd_iter_aniso(xs, c, eta), c0
        )

    return jax.vmap(one)(x_sub, keys)
