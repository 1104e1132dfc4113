"""Pairwise exact sketch-intersection counts on device.

Two implementations with identical semantics:
  * ``pair_counts_jnp`` — plain jnp compare-and-count, the reference (and
    the path on every backend but the GPU).  XLA fuses each slot pair's
    compare and sum into one loop, but walks the (GI, GJ) output once per
    slot pair.
  * ``pair_counts_triton`` — Pallas kernel on the Triton route.  One block
    per (row tile, column tile) of the output; the W^2 slot pairs and the
    K chunks are looped inside the block, so the block's counts stay in
    registers until the single store.

Per-pair work is K * W^2 compares where K = bucket count (~sketch size) and
W = max bucket occupancy.  Counts are exact set-intersection sizes |A∩B|
(see ops/pack.py for why the bucketed compare is exact).  The final
Mash/AAF distances are computed from these integer counts on the host in
float64 — device rounding can never change a cluster decision.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Output tile and K chunk of the Triton kernel.  On an H100 at the dense
# engine's shapes (4096^2 tile, W=12, K=1024) this is the fastest of the
# configurations tried: 32x32x32 with 4 warps; 64x64x16 spills and runs
# 50x slower (PERF.md).
TRITON_TILE = (32, 32, 32)


def pair_counts_jnp(a0, b0, a1=None, b1=None):
    """Exact pair counts: a* (GI, W, K), b* (GJ, W, K) -> (GI, GJ) int32."""
    gi, w, k = a0.shape
    gj = b0.shape[0]
    acc = jnp.zeros((gi, gj), dtype=jnp.int32)
    for r in range(w):
        for s in range(w):
            eq = a0[:, None, r, :] == b0[None, :, s, :]
            if a1 is not None:
                eq &= a1[:, None, r, :] == b1[None, :, s, :]
            acc += jnp.sum(eq, axis=-1, dtype=jnp.int32)
    return acc


def _triton_kernel(*refs, w: int, nk: int, bk: int, two: bool):
    if two:
        a0, a1, b0, b1, out = refs
    else:
        a0, b0, out = refs
    bi, bj = out.shape

    def k_chunk(kc, acc):
        ks = pl.ds(pl.multiple_of(kc * bk, bk), bk)

        def row_slot(r, acc):
            ar0 = a0[:, r, ks]
            ar1 = a1[:, r, ks] if two else None

            def col_slot(s, acc):
                eq = ar0[:, None, :] == b0[:, s, ks][None, :, :]
                if two:
                    eq &= ar1[:, None, :] == b1[:, s, ks][None, :, :]
                return acc + jnp.sum(eq.astype(jnp.int32), axis=2)

            return jax.lax.fori_loop(0, w, col_slot, acc)

        return jax.lax.fori_loop(0, w, row_slot, acc)

    out[...] = jax.lax.fori_loop(0, nk, k_chunk,
                                 jnp.zeros((bi, bj), jnp.int32))


def triton_tiles_fit(gi: int, gj: int, k: int) -> bool:
    bi, bj, bk = TRITON_TILE
    return gi % bi == 0 and gj % bj == 0 and k % bk == 0


@functools.partial(jax.jit, static_argnames=("interpret",))
def pair_counts_triton(a0, b0, a1=None, b1=None, interpret: bool = False):
    """Same contract as ``pair_counts_jnp``; GI, GJ and K must be multiples
    of ``TRITON_TILE`` (``triton_tiles_fit``).  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    gi, w, k = a0.shape
    gj = b0.shape[0]
    if not triton_tiles_fit(gi, gj, k):
        raise ValueError(f"shapes {a0.shape} x {b0.shape} do not tile by "
                         f"{TRITON_TILE}")
    bi, bj, bk = TRITON_TILE
    two = a1 is not None
    kern = functools.partial(_triton_kernel, w=w, nk=k // bk, bk=bk, two=two)
    a_spec = pl.BlockSpec((bi, w, k), lambda i, j: (i, 0, 0))
    b_spec = pl.BlockSpec((bj, w, k), lambda i, j: (j, 0, 0))
    in_specs = [a_spec, a_spec, b_spec, b_spec] if two else [a_spec, b_spec]
    args = (a0, a1, b0, b1) if two else (a0, b0)
    return pl.pallas_call(
        kern,
        grid=(gi // bi, gj // bj),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((bi, bj), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((gi, gj), jnp.int32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="pair_counts_triton",
    )(*args)


def pick_pair_kernel(platform: str, gi: int, gj: int, k: int) -> str:
    """"triton" on a GPU when the shapes tile, else "jnp"."""
    return "triton" if platform == "gpu" and triton_tiles_fit(gi, gj, k) \
        else "jnp"


def pair_counts_row(a_block, b_packed, gj_tile: int = 128):
    """Counts of a PackedSketches row block against all packed columns."""
    return _pair_counts_row_jnp(
        jnp.asarray(a_block.plane0), jnp.asarray(b_packed.plane0),
        None if a_block.plane1 is None else jnp.asarray(a_block.plane1),
        None if b_packed.plane1 is None else jnp.asarray(b_packed.plane1),
        gj_tile=gj_tile)


@functools.partial(jax.jit, static_argnames=("gj_tile",))
def _pair_counts_row_jnp(a0, b0, a1=None, b1=None, gj_tile: int = 128):
    n = b0.shape[0]

    def body(carry, j):
        sl = jax.lax.dynamic_slice_in_dim(b0, j * gj_tile, gj_tile, 0)
        sl1 = None if a1 is None else jax.lax.dynamic_slice_in_dim(
            b1, j * gj_tile, gj_tile, 0)
        return carry, pair_counts_jnp(a0, sl, a1, sl1)

    _, tiles = jax.lax.scan(body, None, jnp.arange(n // gj_tile))
    # tiles: (nJ, GI, gj_tile) -> (GI, N)
    return jnp.transpose(tiles, (1, 0, 2)).reshape(a0.shape[0], n)
