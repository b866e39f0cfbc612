"""PQ lookup-table scan as a Pallas kernel on the Triton route (GPU).

The classic GPU PQ-scan design: each program owns a block of queries and a
block of codes, streams the codes subspace by subspace and gathers the
matching lookup-table entries, summing them in registers. No one-hot
matrix is formed, and a query's [M*K] table (64 KB at M=64, K=256) stays
cache-resident while its codes stream past.

Layouts (M and K zero-padded to powers of two, as Triton block shapes
must be; the loop runs over the M real subspaces only, so the padding
costs memory, not work):
  codes [M, N] uint8 (code-major, so one subspace's codes load contiguously)
  luts  [Q, M*K] f32
  out   [Q, N] f32 accumulated ADC values (ops/adc.py convention)

The sums are plain float32 adds, so the result matches the XLA gather form
(`ops/adc.lookup_scan_xla`) to float32 rounding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Block shape and warps: within noise of the fastest of the configurations
# timed on an H100 at Q=512, N=262,144, M=64, K=256 (CHANGES.md).
BLOCK_Q = 4
BLOCK_N = 512
NUM_WARPS = 4


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _adc_kernel(codes_ref, luts_ref, out_ref, *, m: int, k: int):
    """m: real subspaces (the loop bound); k: padded table row stride."""
    bq, bn = out_ref.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (bq, bn), 0)

    def body(mi, acc):
        code = codes_ref[mi, :].astype(jnp.int32)  # [BN]
        cols = jnp.broadcast_to(code[None, :] + mi * k, (bq, bn))
        return acc + luts_ref[rows, cols]

    out_ref[...] = jax.lax.fori_loop(
        0, m, body, jnp.zeros((bq, bn), jnp.float32))


@functools.partial(jax.jit,
                   static_argnames=("block_q", "block_n", "num_warps",
                                    "interpret"))
def adc_scan_triton(
    luts: jax.Array,  # [Q, M, K] f32
    codes: jax.Array,  # [N, M] uint8/int32, values < K <= 256
    block_q: int = BLOCK_Q,
    block_n: int = BLOCK_N,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> jax.Array:
    """Accumulated ADC values for every code row -> [Q, N] f32."""
    q, m, k = luts.shape
    n = codes.shape[0]
    mp, kp = _pow2(m), _pow2(k)
    pad_q = (-q) % block_q
    pad_n = (-n) % block_n
    flat = jnp.pad(luts.astype(jnp.float32),
                   ((0, pad_q), (0, mp - m), (0, kp - k)))
    flat = flat.reshape(q + pad_q, mp * kp)
    codes_t = jnp.pad(codes.astype(jnp.uint8),
                      ((0, pad_n), (0, mp - m))).T  # [Mp, N]
    qp, np_ = q + pad_q, n + pad_n
    out = pl.pallas_call(
        functools.partial(_adc_kernel, m=m, k=kp),
        grid=(qp // block_q, np_ // block_n),
        in_specs=[
            pl.BlockSpec((mp, block_n), lambda i, j: (0, j)),
            pl.BlockSpec((block_q, mp * kp), lambda i, j: (i, 0)),
        ],
        out_specs=pl.BlockSpec((block_q, block_n), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((qp, np_), jnp.float32),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name="adc_scan_triton",
    )(codes_t, flat)
    return out[:q, :n]
