"""Bitmap candidate filter — the scalable device path for threshold-bounded
clustering (clusters / greedy probing / serving).

Idea: each genome gets a B-bit signature (bit set iff some sketch hash maps
to it); the matrix product  X_rows @ X^T  of the 0/1 signatures computes
shared-bit counts for all pairs on the tensor cores (B MACs/pair).  A
deterministic lower bound makes the filter *safe* (no false negatives):

    shared_bits(i,j) >= common(i,j) - min(c_i, c_j)

where c_g = sketch_size_g - popcount(signature_g) is genome g's internal
collision count (known exactly at pack time).  A pair can reach distance
<= d only if common >= common_min(i,j), so keeping pairs with

    shared_bits >= common_min(i,j) - min(c_i, c_j)

never drops a true candidate.  Survivors are verified exactly with the
native two-pointer kernel (utils/native.rtc_count_common_*), and final
distances use float64 on the host — bit-exact clustering at matmul speed.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import time
from typing import List, Tuple

import numpy as np

from ..distance.mash import min_jaccard_for_threshold, size_ratio_limit
from ..utils import native as native_mod

_MIX64 = np.uint64(0x9E3779B97F4A7C15)

# device->host transfer accounting for the candidate filter (read by
# bench.py to evidence the pulled-byte budget; reset_pull_stats() to zero)
PULL_STATS = {"bytes": 0, "pulls": 0}


def reset_pull_stats() -> None:
    PULL_STATS["bytes"] = 0
    PULL_STATS["pulls"] = 0


def _account_pull(n_bytes: int) -> None:
    PULL_STATS["bytes"] += int(n_bytes)
    PULL_STATS["pulls"] += 1


def pack_bitmaps(hashes: List[np.ndarray], bits: int = 8192,
                 pad_n_to: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X int8 (N_pad, bits), collisions int32 (N_pad,))."""
    n = len(hashes)
    n_pad = max(((n + pad_n_to - 1) // pad_n_to) * pad_n_to, pad_n_to)
    shift = np.uint64(64 - int(math.log2(bits)))
    x = np.zeros((n_pad, bits), dtype=np.int8)
    coll = np.zeros(n_pad, dtype=np.int32)
    if n:
        sizes = np.array([len(h) for h in hashes], dtype=np.int64)
        gid = np.repeat(np.arange(n, dtype=np.int64), sizes)
        hv = np.concatenate(hashes).astype(np.uint64)
        with np.errstate(over="ignore"):
            b = ((hv * _MIX64) >> shift).astype(np.int64)
        x[gid, b] = 1
        coll[:n] = sizes - x[:n].sum(axis=1, dtype=np.int64)
    return x, coll


def pack_bitmaps_packed(hashes: List[np.ndarray], bits: int = 8192,
                        pad_n_to: int = 128
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-packed signatures: (uint8 (N_pad, bits//8), collisions int32).
    Native C++ fast path; same bit layout as np.packbits(bitorder='little')
    of pack_bitmaps output."""
    import os
    n = len(hashes)
    n_pad = max(((n + pad_n_to - 1) // pad_n_to) * pad_n_to, pad_n_to)
    lib = native_mod.load_native()
    if lib is None or n == 0:
        x, coll = pack_bitmaps(hashes, bits=bits, pad_n_to=pad_n_to)
        return np.packbits(x, axis=1, bitorder="little"), coll
    use64 = hashes[0].dtype == np.uint64
    # parallel native gather: np.concatenate over 64k small arrays costs
    # seconds per chunk at 1M genomes (67 us/array) — rtc_flatten doesn't
    flat, offs = native_mod.flatten_csr(hashes, use64)
    out = np.zeros((n_pad, bits // 8), dtype=np.uint8)
    coll = np.zeros(n_pad, dtype=np.int32)
    fn = lib.rtc_pack_bitmaps_u64 if use64 else lib.rtc_pack_bitmaps_u32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int]
    fn(flat.ctypes.data, offs.ctypes.data, n, bits, out.ctypes.data,
       coll.ctypes.data, os.cpu_count() or 1)
    return out, coll


def pack_bitmaps_packed_staged(hashes: List[np.ndarray], bits: int = 8192,
                               pad_n_to: int = 128, chunk: int = 65536):
    """Bit-pack AND stage the signatures to the device with pack/transfer
    overlap: each row chunk is packed natively (ctypes releases the GIL)
    while the previous chunk's ``jax.device_put`` transfer is in flight,
    so the pack and the push overlap.  Returns
    (xd device uint8 (n_pad, bits//8), collisions int32 host (n_pad,)).
    Bit layout identical to pack_bitmaps_packed.  Chunks are 64 MB at the
    default bits, a size chosen on other hardware for a transfer path with
    a large fixed cost per call; re-deciding it on the H100 is ROADMAP
    1.2/3.2."""
    import jax
    import jax.numpy as jnp

    n = len(hashes)
    n_pad = max(((n + pad_n_to - 1) // pad_n_to) * pad_n_to, pad_n_to)
    chunk = int(os.environ.get("RTC_PACK_CHUNK", chunk))
    if chunk <= 0:  # single-put mode: pack everything, push once
        chunk = n_pad
    parts = []
    colls = []
    done = 0
    t_nat = t_put = 0.0
    while done < n_pad:
        end = min(done + chunk, n_pad)
        rows = end - done
        sub = hashes[done:min(end, n)]
        t0 = time.perf_counter()
        if sub:
            xp_c, coll_c = pack_bitmaps_packed(sub, bits=bits, pad_n_to=1)
            if xp_c.shape[0] < rows:  # tail padding rows
                xp_c = np.vstack([xp_c, np.zeros(
                    (rows - xp_c.shape[0], bits // 8), dtype=np.uint8)])
                coll_c = np.concatenate([coll_c, np.zeros(
                    rows - len(coll_c), dtype=np.int32)])
        else:
            xp_c = np.zeros((rows, bits // 8), dtype=np.uint8)
            coll_c = np.zeros(rows, dtype=np.int32)
        t1 = time.perf_counter()
        parts.append(jax.device_put(xp_c))  # async; overlaps next pack
        t_put += time.perf_counter() - t1
        t_nat += t1 - t0
        colls.append(coll_c[:rows])
        done = end
    t1 = time.perf_counter()
    xd = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    PACK_STATS.update(native_s=round(t_nat, 2),
                      put_dispatch_s=round(t_put, 2),
                      concat_dispatch_s=round(time.perf_counter() - t1, 2),
                      chunks=len(parts), chunk_rows=chunk)
    return xd, np.concatenate(colls)


# sub-phase decomposition of the last pack_bitmaps_packed_staged call
# (native pack vs device_put dispatch vs device concat dispatch; the
# async transfer itself lands in whichever op blocks on it next)
PACK_STATS: dict = {}


def _unpack_bits_device(xp, dtype=None):
    """(N, B//8) uint8 -> (N, B) 0/1 on device (default bfloat16).

    bf16 x bf16 -> f32 runs on the tensor cores (cuBLAS) and is EXACT here:
    products are 0/1 and the f32 accumulator is exact for counts <= 2^24,
    far above any signature width; with no float32 operand, TF32 never
    applies (chip_smoke.py phase f checks the product on the card).
    Whether int8 operands (twice the bf16 tensor-core rate on the H100,
    and no 8x unpack) pay off is ROADMAP 1.4."""
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.bfloat16
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (xp[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    return bits.reshape(xp.shape[0], -1).astype(dtype)


def _filter_block_fn(xi, x, ci, c, si, s, row_start, col_start, jmin_num,
                     jmin_den, c_min, radio, is_containment, cap):
    """Device: shared-bit counts + safe candidate mask for one pair tile
    (rows [row_start, row_start+gi) x columns [col_start, col_start+gj)).

    ``xi``/``x`` are bit-packed uint8 signatures (transferred 8x smaller and
    unpacked on device).  Returns one fused int32 array
    [count, flat_idx(cap)] where flat = local_i * gj + local_j."""
    import jax
    import jax.numpy as jnp

    xi = _unpack_bits_device(xi)
    x = _unpack_bits_device(x)
    shared = jax.lax.dot_general(
        xi, x, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    si_c = si[:, None].astype(jnp.float32)
    s_c = s[None, :].astype(jnp.float32)
    # float32 bound with a -2 safety margin: the device bound must never
    # exceed the exact float64 ceil the host uses (false negatives are
    # correctness bugs; false positives only cost verify work)
    if is_containment:
        mn = jnp.minimum(si_c, s_c)
        common_min = jnp.floor(c_min * mn).astype(jnp.int32) - 1
    else:
        common_min = jnp.floor(
            jmin_num * (si_c + s_c) / jmin_den).astype(jnp.int32) - 1
    thresh = common_min - jnp.minimum(ci[:, None], c[None, :])
    mni = jnp.minimum(si[:, None], s[None, :])
    mxi = jnp.maximum(si[:, None], s[None, :])
    ratio_ok = (mni > 0) & (mxi <= radio * mni)
    gi, gj = shared.shape
    jidx = jax.lax.broadcasted_iota(jnp.int32, (gi, gj), 1) + col_start
    iidx = jax.lax.broadcasted_iota(jnp.int32, (gi, gj), 0) + row_start
    mask = (shared >= thresh) & ratio_ok & (jidx < iidx)
    # device-side compaction, one fused minimal int32 result
    # [count, flat_idx(cap)]: everything returns in ONE array, so one
    # device->host pull serves the count and the indices.
    count = jnp.sum(mask, dtype=jnp.int32)
    (flat_idx,) = jnp.nonzero(mask.reshape(-1), size=cap, fill_value=-1)
    return jnp.concatenate([count[None], flat_idx.astype(jnp.int32)])


@functools.lru_cache(maxsize=1)
def _jitted_filter():
    import jax
    return jax.jit(_filter_block_fn,
                   static_argnames=("is_containment", "cap"))


def _tile_mask(xd, cd, sd, r0, c0, rb, jmin_num, jmin_den, c_min, radio,
               is_containment, bound="mst"):
    """Safe candidate mask for tile (rows r0:r0+rb x cols c0:c0+rb) of the
    resident packed-signature matrix (shared by the index- and mask-pull
    batched programs).

    ``bound`` selects the size-ratio prefilter semantics:
      * "mst": the reference's integer ``max <= calr(t, k-1) * min`` prune
        (src/MST.cpp:224,509 — intentionally tighter than the mathematical
        implication of d <= t; a replicated reference quirk), ``radio``
        traced int32;
      * "greedy": the exact implication of the greedy accept rule — mash:
        float ``max <= (2e^{tk}-1) * min + 1`` (+1 f32 slack; greedy.cpp
        never prunes harder than its own bound), containment: NO ratio
        (a small sketch may be contained in an arbitrarily large one);
        ``radio`` traced float32.  Used by ops.greedy_device's sweep;
      * "minhash": the MinHash-parity greedy bound (greedy.cpp:986-1360) —
        ``sd`` is STACKED (2, n_pad): row 0 = actual kept-hash counts
        (query side), row 1 = reference param sizes (rep side; the
        asymmetry the reference has).  standard: common >=
        jmin*(len_row+psize_col)/(1+jmin); containment: the caller passes
        c_min := j_min so common >= jmin*min(len_row, psize_col).  No
        ratio prune (``radio`` unused); padding excluded via min size > 0."""
    import jax
    import jax.numpy as jnp

    xi = _unpack_bits_device(jax.lax.dynamic_slice(
        xd, (r0, jnp.int32(0)), (rb, xd.shape[1])))
    xj = _unpack_bits_device(jax.lax.dynamic_slice(
        xd, (c0, jnp.int32(0)), (rb, xd.shape[1])))
    ci = jax.lax.dynamic_slice(cd, (r0,), (rb,))
    cj = jax.lax.dynamic_slice(cd, (c0,), (rb,))
    if bound == "minhash":
        si = jax.lax.dynamic_slice(sd[0], (r0,), (rb,))
        sj = jax.lax.dynamic_slice(sd[1], (c0,), (rb,))
    else:
        si = jax.lax.dynamic_slice(sd, (r0,), (rb,))
        sj = jax.lax.dynamic_slice(sd, (c0,), (rb,))
    shared = jax.lax.dot_general(
        xi, xj, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    si_c = si[:, None].astype(jnp.float32)
    s_c = sj[None, :].astype(jnp.float32)
    if is_containment:
        mn = jnp.minimum(si_c, s_c)
        common_min = jnp.floor(c_min * mn).astype(jnp.int32) - 1
    else:
        common_min = jnp.floor(
            jmin_num * (si_c + s_c) / jmin_den).astype(jnp.int32) - 1
    thresh = common_min - jnp.minimum(ci[:, None], cj[None, :])
    mni = jnp.minimum(si[:, None], sj[None, :])
    if bound == "minhash":
        ratio_ok = mni > 0
    elif bound == "greedy":
        if is_containment:
            ratio_ok = mni > 0
        else:
            mn_f = jnp.minimum(si_c, s_c)
            mx_f = jnp.maximum(si_c, s_c)
            ratio_ok = (mni > 0) & (mx_f <= radio * mn_f + 1.0)
    else:
        mxi = jnp.maximum(si[:, None], sj[None, :])
        ratio_ok = (mni > 0) & (mxi <= radio * mni)
    jidx = jax.lax.broadcasted_iota(jnp.int32, (rb, rb), 1) + c0
    iidx = jax.lax.broadcasted_iota(jnp.int32, (rb, rb), 0) + r0
    return (shared >= thresh) & ratio_ok & (jidx < iidx)


def compact_mask_two_level(mask, cap_tile: int, cap_chunks: int):
    """(count, flat indices (cap_tile,) int32, -1 padded) of a 2-D mask.

    jnp.nonzero over a big flat mask costs a pass over the whole mask
    whatever the density (48.7 ms per sparse 8192^2 tile on an H100,
    PERF.md).  Two-level version: reduce to W-wide column-chunk occupancy
    (cheap), nonzero over the tiny chunk grid, row-gather the hit chunks,
    nonzero over cap_chunks*W elements — output-proportional for sparse
    masks (1.75 ms on the same tile).  SAFETY: requires
    chunks_hit <= cap_chunks; since chunks_hit <= count, any caller that
    guarantees count <= cap_chunks (exact pre-counts, or a count>cap
    regrow check) can never truncate.  Falls back to flat nonzero when
    the column count does not divide by the chunk width."""
    import jax.numpy as jnp

    nrows, ncols = mask.shape
    count = jnp.sum(mask, dtype=jnp.int32)
    w = min(512, ncols)
    if ncols % w or cap_chunks >= nrows * (ncols // w):
        (flat,) = jnp.nonzero(mask.reshape(-1), size=cap_tile,
                              fill_value=-1)
        return count, flat.astype(jnp.int32)
    ncc = ncols // w
    m3 = mask.reshape(nrows, ncc, w)
    chunk_any = m3.any(axis=2).reshape(-1)
    (cid,) = jnp.nonzero(chunk_any, size=cap_chunks, fill_value=-1)
    okc = cid >= 0
    rows = jnp.maximum(cid, 0) // ncc
    cols = jnp.maximum(cid, 0) % ncc
    sub = m3[rows, cols] & okc[:, None]
    (loc,) = jnp.nonzero(sub.reshape(-1), size=cap_tile, fill_value=-1)
    c2 = jnp.maximum(loc, 0) // w
    flat = rows[c2] * jnp.int32(ncols) + cols[c2] * jnp.int32(w) \
        + jnp.maximum(loc, 0) % w
    return count, jnp.where(loc >= 0, flat, -1).astype(jnp.int32)


def pack_mask_u8(mask):
    """Bit-pack a boolean (r, c) mask to (r, c//8) uint8, little bit-order
    (the inverse of np.unpackbits(bitorder="little"); decoded on the host
    by _decode_packed_mask).  Pure vector ALU — shared by every engine
    that pulls packed masks (this module and ops.engine)."""
    import jax.numpy as jnp

    r, c = mask.shape
    bits = mask.reshape(r, c // 8, 8).astype(jnp.int32)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.int32)
    return jnp.sum(bits * weights, axis=2).astype(jnp.uint8)


def _batched_mask_fn(xd, cd, sd, r0s, c0s, valid, jmin_num, jmin_den,
                     c_min, radio, is_containment, rb, bound="mst"):
    """Batch filter WITHOUT device-side index compaction: each tile returns
    its candidate mask bit-PACKED (rb x rb//8 uint8) plus its count.

    Bit-packing is pure elementwise work (~free), moves rb^2/8 bytes per
    tile to the host regardless of density, and the host decodes it with
    np.unpackbits+flatnonzero, overlapped with the next batch's device
    work; index compaction (jnp.nonzero) costs a density-independent
    device pass per tile instead.
    The index-compaction program (_batched_filter_fn) remains the better
    choice when candidates are sparse: 4*count bytes << rb^2/8.
    candidate_pair_blocks switches adaptively."""
    import jax
    import jax.numpy as jnp

    def compute_tile(r0, c0):
        mask = _tile_mask(xd, cd, sd, r0, c0, rb, jmin_num, jmin_den,
                          c_min, radio, is_containment, bound)
        count = jnp.sum(mask, dtype=jnp.int32)
        return count, pack_mask_u8(mask)

    def body(_, tile):
        r0, c0, ok = tile
        count, packed = jax.lax.cond(
            ok > 0,
            lambda: compute_tile(r0, c0),
            lambda: (jnp.int32(0),
                     jnp.zeros((rb, rb // 8), dtype=jnp.uint8)))
        return 0, (count, packed)

    _, (counts, packs) = jax.lax.scan(body, 0, (r0s, c0s, valid))
    return counts, packs


@functools.lru_cache(maxsize=1)
def _jitted_batched_mask():
    import jax
    return jax.jit(_batched_mask_fn,
                   static_argnames=("is_containment", "rb", "bound"))


def _batched_filter_fn(xd, cd, sd, ts, r0s, c0s, valid, jmin_num, jmin_den,
                       c_min, radio, is_containment, cap_tile, cap_chunks,
                       rb, bound="mst"):
    """ONE device dispatch for a whole batch of (rb x rb) pair tiles,
    returning compacted candidate indices (the sparse-tile pull mode).

    lax.scan over tile descriptors: each step dynamic-slices its row/column
    panels out of the resident signature matrix, runs the bf16 filter,
    and appends its compacted candidate indices into a shared buffer at the
    running total (dynamic_update_slice).  Encodes flat = t*rb^2 + local so
    the host decodes with the batch's (r0, c0) list.  Returns one fused
    int32 array [total, max_tile_count, buffer(k*cap_tile)].  Invalid
    (padding) tiles skip the matmul entirely via lax.cond.

    Compaction is TWO-LEVEL to dodge jnp.nonzero's density-independent
    cost on the full tile: a cheap reduction finds
    the W-wide column chunks with any candidate (nonzero over rb^2/W
    elements), the hit chunks are row-gathered, and the small nonzero runs
    over cap_chunks*W elements only — output-proportional for sparse tiles.
    Safe sizing: chunks_hit <= count <= cap_chunks (host sets cap_chunks
    from the exact counts), so neither level can truncate.

    Batching k tiles per dispatch cuts device<->host round-trips k-fold
    while the compiled shape stays N-independent (fixed rb, k)."""
    import jax
    import jax.numpy as jnp

    k = ts.shape[0]
    buf = jnp.full((k * cap_tile,), -1, dtype=jnp.int32)

    def compute_tile(t, r0, c0):
        mask = _tile_mask(xd, cd, sd, r0, c0, rb, jmin_num, jmin_den,
                          c_min, radio, is_containment, bound)
        count, flat = compact_mask_two_level(mask, cap_tile, cap_chunks)
        return flat + t * jnp.int32(rb * rb), count

    def body(carry, tile):
        buf, total, maxc = carry
        t, r0, c0, ok = tile
        enc, count = jax.lax.cond(
            ok > 0,
            lambda: compute_tile(t, r0, c0),
            lambda: (jnp.full((cap_tile,), -1, dtype=jnp.int32),
                     jnp.int32(0)))
        # write at the running total: entries past `count` are garbage but
        # are overwritten by the next tile's write (which starts at
        # total+count and spans cap_tile) or fall beyond the final total
        buf = jax.lax.dynamic_update_slice(buf, enc, (total,))
        return (buf, total + count, jnp.maximum(maxc, count)), None

    (buf, total, maxc), _ = jax.lax.scan(
        body, (buf, jnp.int32(0), jnp.int32(0)), (ts, r0s, c0s, valid))
    return jnp.concatenate([total[None], maxc[None], buf])


@functools.lru_cache(maxsize=1)
def _jitted_batched_filter():
    import jax
    return jax.jit(_batched_filter_fn,
                   static_argnames=("is_containment", "cap_tile",
                                    "cap_chunks", "rb", "bound"))


def _blocks_batched(hashes, threshold, kmer_size, is_containment, bits,
                    row_block, batch_k, bound="mst", col_sizes=None,
                    markers=False, row_sizes=None):
    """Batched-dispatch candidate generator (default device path).

    Per batch of up to batch_k tiles:
      1. dispatch the cheap mask program (_batched_mask_fn: filter + packed
         masks, no compaction) and pull the per-tile counts (k ints);
      2. with the exact counts in hand, pull EITHER the packed masks
         (dense: n_valid*rb^2/8 bytes, zero device compaction time) OR
         dispatch the index-compaction program sized exactly
         (sparse: 4*total bytes, pays jnp.nonzero's per-tile device pass).
    The dense/sparse decision is per batch (RTC_PULL_MODE=auto|mask|idx).
    The next batch's mask program is dispatched before this batch's data
    pull so device filtering overlaps host decode/verify."""
    import jax.numpy as jnp
    from ..utils.jaxcfg import configure_jax
    configure_jax()

    n = len(hashes)
    # power-of-two tile ladder: small inputs compile small shapes, large
    # inputs all share (row_block, row_block) regardless of N
    rb = min(row_block, max(128, 1 << max(n - 1, 1).bit_length()))
    xp, coll = pack_bitmaps_packed(hashes, bits=bits, pad_n_to=rb)
    n_pad = xp.shape[0]
    sizes = np.zeros(n_pad, dtype=np.int32)
    if row_sizes is not None:  # caller-supplied row/query-side sizes
        sizes[:n] = np.asarray(row_sizes, dtype=np.int64)[:n]
    else:
        sizes[:n] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    if bound == "minhash":
        # containment accept is common >= ceil(j_min * min(len, psize))
        # (greedy.cpp:986-1360) — j_min rides the c_min scalar slot
        c_min = j_min
        radio_scalar = jnp.float32(0.0)  # unused in this bound
    elif bound == "greedy":
        radio_scalar = jnp.float32(2.0 * math.exp(threshold * kmer_size)
                                   - 1.0)
    else:
        radio_scalar = jnp.int32(size_ratio_limit(threshold, kmer_size - 1))

    xd = jnp.asarray(xp)
    cd = jnp.asarray(coll)
    if bound == "minhash":
        cs = np.zeros(n_pad, dtype=np.int32)
        cs[:n] = np.asarray(col_sizes, dtype=np.int64)[:n]
        sd = jnp.asarray(np.stack([sizes, cs]))
    else:
        sd = jnp.asarray(sizes)
    mask_filt = _jitted_batched_mask()
    idx_filt = _jitted_batched_filter()
    pull_mode = os.environ.get("RTC_PULL_MODE", "auto")

    # triangular tile sweep, chunked into fixed-k batches (padding tiles
    # are skipped on device via lax.cond — no wasted matmuls)
    tiles = []
    for r0 in range(0, n_pad, rb):
        for c0 in range(0, r0 + rb, rb):
            tiles.append((r0, c0))
    batches = [tiles[b:b + batch_k] for b in range(0, len(tiles), batch_k)]

    def batch_markers(batch):
        # a row panel's pairs are complete once its DIAGONAL tile
        # (c0 == r0) has been yielded — tiles sweep (r0 asc, c0 asc)
        return [("panel", min(r0 + rb, n)) for r0, c0 in batch if c0 == r0]
    scalars = (jnp.float32(j_min), jnp.float32(1.0 + j_min),
               jnp.float32(c_min), radio_scalar)

    def tile_arrays(batch):
        r0s = np.zeros(batch_k, dtype=np.int32)
        c0s = np.zeros(batch_k, dtype=np.int32)
        val = np.zeros(batch_k, dtype=np.int32)
        for t, (r0, c0) in enumerate(batch):
            r0s[t], c0s[t], val[t] = r0, c0, 1
        return r0s, c0s, val

    def dispatch_mask(batch):
        r0s, c0s, val = tile_arrays(batch)
        counts_dev, packs_dev = mask_filt(
            xd, cd, sd, jnp.asarray(r0s), jnp.asarray(c0s),
            jnp.asarray(val), *scalars, is_containment, rb, bound)
        try:
            counts_dev.copy_to_host_async()
        except Exception:
            pass
        return counts_dev, packs_dev, r0s, c0s, len(batch)

    def dispatch_idx(batch, cap, cap_chunks):
        r0s, c0s, val = tile_arrays(batch)
        return idx_filt(xd, cd, sd, jnp.arange(batch_k, dtype=jnp.int32),
                        jnp.asarray(r0s), jnp.asarray(c0s),
                        jnp.asarray(val), *scalars, is_containment, cap,
                        cap_chunks, rb, bound)

    pending = dispatch_mask(batches[0]) if batches else None
    for b, batch in enumerate(batches):
        counts_dev, packs_dev, r0s, c0s, n_valid = pending
        counts = np.asarray(counts_dev)
        _account_pull(4 * batch_k)
        total = int(counts.sum())
        if not total:
            if b + 1 < len(batches):
                pending = dispatch_mask(batches[b + 1])
            if markers:
                yield from batch_markers(batch)
            continue
        # per-TILE pull policy: packed mask costs rb^2/8 bytes and zero
        # device compaction; index compaction costs 4*count bytes (< 2x
        # quantum overshoot) plus jnp.nonzero's density-independent
        # per-tile device time, expressed in byte-equivalents via
        # the live bandwidth estimate
        tile_bytes = rb * (rb // 8)
        compact_equiv = _COMPACT_S_PER_PAIR * rb * rb * _BW_EST["bps"]
        sel_mask, sel_idx = [], []
        for t in range(n_valid):
            if not counts[t]:
                continue
            if pull_mode == "mask" or (pull_mode != "idx" and tile_bytes
                                       <= compact_equiv + 4 * int(counts[t])):
                sel_mask.append(t)
            else:
                sel_idx.append(t)
        packs_pull = None
        if sel_mask:
            packs_pull = packs_dev[jnp.asarray(sel_mask, dtype=jnp.int32)]
        prefix_dev = None
        if sel_idx:
            sub = [batch[t] for t in sel_idx]
            cnts_idx = counts[np.asarray(sel_idx)]
            total_idx = int(cnts_idx.sum())
            # exact counts known: size both compaction levels to the ladder
            # step >= max tile count (chunks_hit <= count) — no regrow pass
            # or truncation can ever occur
            maxc = int(cnts_idx.max())
            cap_tile = min(_pull_quantum(maxc, rb * rb), rb * rb)
            w_chunk = min(512, rb)
            cap_chunks = min(_quantum(maxc, 1 << 11), rb * rb // w_chunk)
            fused_dev = dispatch_idx(sub, cap_tile, cap_chunks)
            quantum = _pull_quantum(total_idx, batch_k * cap_tile)
            prefix_dev = fused_dev[2:2 + quantum]
        if b + 1 < len(batches):
            pending = dispatch_mask(batches[b + 1])
        if packs_pull is not None:
            t0 = time.perf_counter()
            packs = np.ascontiguousarray(np.asarray(packs_pull))
            _note_pull_time(packs.nbytes, time.perf_counter() - t0)
            _account_pull(packs.nbytes)
            for s_i, t in enumerate(sel_mask):
                ii, jj = _decode_packed_mask(packs[s_i], rb, int(r0s[t]),
                                             int(c0s[t]), n, int(counts[t]))
                yield ii, jj
        if prefix_dev is not None:
            t0 = time.perf_counter()
            enc = np.asarray(prefix_dev)[:total_idx].astype(np.int64)
            _note_pull_time(4 * quantum, time.perf_counter() - t0)
            _account_pull(4 * quantum)
            t_loc = enc // (rb * rb)
            local = enc - t_loc * (rb * rb)
            sub_r0 = np.array([s[0] for s in sub], dtype=np.int64)
            sub_c0 = np.array([s[1] for s in sub], dtype=np.int64)
            ii = sub_r0[t_loc] + local // rb
            jj = sub_c0[t_loc] + local % rb
            keep = ii < n
            yield ii[keep], jj[keep]
        if markers:
            yield from batch_markers(batch)


def candidate_pair_blocks(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 1024,
    bound: str = "mst",
    col_sizes=None,
    markers: bool = False,
    row_sizes=None,
):
    """Streaming bitmap candidate filter: yields (ii, jj) int64 arrays of
    unverified candidate pairs (i > j).

    Default path: scan-batched tiles — RTC_BATCH_TILES tiles (default 16)
    of the triangular sweep run in ONE device dispatch (_batched_filter_fn),
    so the number of device<->host round-trips drops k-fold; set
    RTC_BATCH_TILES=0 for the legacy per-tile dispatch path (A/B).

    Pipelined either way: the NEXT batch's device program is dispatched
    (JAX async dispatch) BEFORE the current batch's compacted result is
    pulled, so device filtering of batch b+1 overlaps the caller's host
    work on batch b (exact verify / union-find).

    ``bound`` ("mst" | "greedy" | "minhash") selects the prefilter
    semantics (see _tile_mask); non-"mst" bounds always use the batched
    path.  "minhash" requires ``col_sizes`` (per-genome reference param
    sizes for the rep/column side of every pair).  ``markers=True``
    additionally yields ("panel", row_end) tuples once every pair with
    ii < row_end has been yielded (streaming consumers free buffers and
    replay rows incrementally; forces the batched path).
    """
    batch_k = int(os.environ.get("RTC_BATCH_TILES", "16"))
    if batch_k >= 2 or bound != "mst" or markers:
        yield from _blocks_batched(hashes, threshold, kmer_size,
                                   is_containment, bits, row_block,
                                   max(batch_k, 2), bound, col_sizes,
                                   markers, row_sizes)
        return
    yield from _blocks_pertile(hashes, threshold, kmer_size, is_containment,
                               bits, row_block)


def _blocks_pertile(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 1024,
):
    """Legacy per-tile dispatch path (RTC_BATCH_TILES=0)."""
    import jax.numpy as jnp
    from ..utils.jaxcfg import configure_jax
    configure_jax()

    n = len(hashes)
    xp, coll = pack_bitmaps_packed(hashes, bits=bits, pad_n_to=128)
    n_pad = xp.shape[0]
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    radio = size_ratio_limit(threshold, kmer_size - 1)

    xd = jnp.asarray(xp)  # 8x smaller transfer; unpacked on device
    cd = jnp.asarray(coll)
    sd = jnp.asarray(sizes)
    filt = _jitted_filter()
    # compaction buffer sized for <=3% pair density of one tile (covers
    # heavily clustered data; with two-step pulls a larger cap costs device
    # memory only, never pull bandwidth); a grown cap persists across tiles
    # (every distinct cap is a fresh compile)
    cur_cap = max(1 << 20, min(row_block, n_pad) ** 2 // 32)
    full_pull = bool(int(os.environ.get("RTC_FULL_PULL", "0")))

    def dispatch(r0, gi, c0, gj, cap):
        fused = filt(
            xd[r0:r0 + gi], xd[c0:c0 + gj], cd[r0:r0 + gi], cd[c0:c0 + gj],
            sd[r0:r0 + gi], sd[c0:c0 + gj],
            jnp.int32(r0), jnp.int32(c0), jnp.float32(j_min),
            jnp.float32(1.0 + j_min), jnp.float32(c_min), jnp.int32(radio),
            is_containment, cap)
        # start the 4-byte count transfer as soon as the filter completes on
        # device, so by the time the host needs it (after verifying the
        # previous tile) it has usually already landed
        cnt = fused[:1]
        if not full_pull:
            try:
                cnt.copy_to_host_async()
            except Exception:
                pass
        return fused, cnt, cap

    # square triangular tiling: only pairs j < i survive the mask, so row
    # panel [r0, r0+gi) needs columns [0, r0+gi) only — chunked into
    # row_block-wide tiles.  Exactly halves the filter FLOPs vs full
    # panels and every interior tile shares ONE compiled shape
    # (row_block, row_block) independent of N, so new dataset sizes skip
    # the compile of the main kernel.
    tiles = []
    for r0 in range(0, n_pad, row_block):
        gi = min(row_block, n_pad - r0)
        for c0 in range(0, r0 + gi, row_block):
            tiles.append((r0, gi, c0, min(row_block, n_pad - c0)))

    pending = dispatch(*tiles[0], cur_cap) if tiles else None
    for t, (r0, gi, c0, gj) in enumerate(tiles):
        fused_dev, cnt_dev, used_cap = pending
        if full_pull:
            # legacy single-pull path (A/B benchmarking): pull the whole
            # cap-sized compacted buffer in one RPC
            if t + 1 < len(tiles):
                pending = dispatch(*tiles[t + 1], cur_cap)
            fused = np.asarray(fused_dev)
            _account_pull(4 * (1 + used_cap))
            count = int(fused[0])
            # compare against the cap THIS buffer was dispatched with (the
            # prefetch may predate a growth), else an overflowing count
            # would silently slice past the buffer and drop candidates
            while count > used_cap:
                cur_cap = max(cur_cap, used_cap * 4)
                used_cap = cur_cap
                fused = np.asarray(dispatch(r0, gi, c0, gj, cur_cap)[0])
                _account_pull(4 * (1 + used_cap))
                count = int(fused[0])
            idx = fused[1:1 + count].astype(np.int64)
        else:
            # two-step count+slice pull: the full cap-sized buffer stays on
            # device; only a quantized prefix of the ACTUAL candidates moves
            # over the (slow, high-latency) link.  Pull bytes drop from
            # 4*cap (4-17 MB/tile, growing with N^2) to
            # ~4*quantum(count) (16K-element floor, 4x ladder).
            count = int(np.asarray(cnt_dev)[0])
            _account_pull(4)
            while count > used_cap:
                cur_cap = max(cur_cap, used_cap * 4)
                used_cap = cur_cap  # rare: recompile with a larger buffer
                fused_dev, cnt_dev, _ = dispatch(r0, gi, c0, gj, cur_cap)
                count = int(np.asarray(cnt_dev)[0])
                _account_pull(4)
            # quantized prefix slice (few distinct shapes -> few tiny
            # compiles), dispatched BEFORE the next tile's filter so it
            # runs immediately and its pull overlaps that filter's compute
            prefix_dev = fused_dev[1:1 + _pull_quantum(count, used_cap)] \
                if count else None
            if t + 1 < len(tiles):
                pending = dispatch(*tiles[t + 1], cur_cap)
            if count:
                idx = np.asarray(prefix_dev)[:count].astype(np.int64)
                _account_pull(4 * _pull_quantum(count, used_cap))
            else:
                idx = None
        if count:
            ii = idx // gj + r0
            jj = idx % gj + c0
            keep = ii < n  # drop padded rows
            yield ii[keep], jj[keep]


def _decode_packed_mask(packed: np.ndarray, rb: int, r0: int, c0: int,
                        n: int, expect: int):
    """Global (ii, jj) int64 pairs from one pulled packed-mask tile.
    Native popcount/ctz bit-scan (~GB/s); NumPy unpackbits fallback."""
    lib = native_mod.load_native()
    if lib is not None:
        if not hasattr(lib, "_rtc_mask_pairs_sig"):
            lib.rtc_mask_pairs.restype = ctypes.c_int64
            lib.rtc_mask_pairs.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib._rtc_mask_pairs_sig = True
        ii = np.empty(expect, dtype=np.int64)
        jj = np.empty(expect, dtype=np.int64)
        got = lib.rtc_mask_pairs(
            packed.ctypes.data, rb, packed.shape[1], r0, c0, n,
            ii.ctypes.data, jj.ctypes.data, os.cpu_count() or 1)
        assert got == expect, (got, expect)  # device count is exact
        return ii, jj
    bits2d = np.unpackbits(packed, axis=1, bitorder="little")
    flat = np.flatnonzero(bits2d)
    ii = flat // rb + r0
    jj = flat % rb + c0
    keep = ii < n  # padded rows (padded cols die on sizes==0)
    return ii[keep], jj[keep]


def _quantum(count: int, floor: int) -> int:
    """Smallest ladder step (floor, 2*floor, 4*floor, ...) >= count."""
    k = floor
    while k < count:
        k *= 2
    return k


def _pull_quantum(count: int, cap: int) -> int:
    """Smallest slice length >= count from a ladder of sizes (16K, 32K,
    64K, ... 2x steps, capped at ``cap``) so pull overshoot stays < 2x and
    the number of distinct slice shapes — each a tiny one-off compile —
    stays O(log cap)."""
    return min(_quantum(count, 1 << 14), cap)


# live device->host bandwidth estimate (bytes/s, EMA over measured pulls);
# seeds the per-tile mask-vs-index pull decision.  Prior: one 8 MiB
# packed-mask pull on an NVIDIA H100 80GB HBM3 (700 W limit) after
# warm-up, 5.8e9 B/s (chip_smoke.py prints the reading).
_BW_EST = {"bps": 5.8e9}
# jnp.nonzero compaction of one 8192^2 tile on the same card: 48.7 ms,
# 7.25e-10 s per pair.  With both priors the packed mask (8 MiB) always
# costs less than compaction, so the index path is taken only after the
# live estimate has fallen; whether it should exist at all is ROADMAP 1.3.
_COMPACT_S_PER_PAIR = 7.25e-10


def _note_pull_time(n_bytes: int, seconds: float) -> None:
    if n_bytes >= (1 << 18) and seconds > 1e-4:
        _BW_EST["bps"] = 0.7 * _BW_EST["bps"] + 0.3 * (n_bytes / seconds)


def candidate_pairs_threshold(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 1024,
    return_shared: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All pairs (i > j) that can possibly have distance <= threshold, with
    exact common counts.  Returns (i, j, common) — every returned pair passed
    the size-ratio filter and common >= 1; callers apply the distance.
    With ``return_shared`` the third column is the (approximate) shared-bit
    count instead and no exact verification is performed.
    """
    cand_i: List[np.ndarray] = []
    cand_j: List[np.ndarray] = []
    for ii, jj in candidate_pair_blocks(
            hashes, threshold, kmer_size, is_containment=is_containment,
            bits=bits, row_block=row_block):
        cand_i.append(ii)
        cand_j.append(jj)
    if not cand_i:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty.copy(), np.empty(0, dtype=np.int64)
    ii = np.concatenate(cand_i)
    jj = np.concatenate(cand_j)
    if return_shared:
        # third column kept for API compatibility (candidate rank order)
        return ii, jj, np.zeros(len(ii), dtype=np.int64)
    common = exact_common_counts(hashes, ii, jj)
    nz = common > 0
    return ii[nz], jj[nz], common[nz].astype(np.int64)


class CsrSketches:
    """Flattened CSR view of a sketch list, built once and reused across
    exact-verification calls."""

    def __init__(self, hashes: List[np.ndarray]):
        self.n = len(hashes)
        self.use64 = self.n > 0 and hashes[0].dtype == np.uint64
        # parallel native gather (rtc_flatten) — np.concatenate costs ~2 s
        # at 131k genomes on the 2-core host, the memcpy loop ~0.3 s
        self.flat, self.offs = native_mod.flatten_csr(hashes, self.use64)

    def count_common(self, ii: np.ndarray, jj: np.ndarray,
                     threads: int = 0) -> np.ndarray:
        import os
        out = np.zeros(len(ii), dtype=np.int32)
        if len(ii) == 0:
            return out
        lib = native_mod.load_native()
        if lib is None:
            o = self.offs
            f = self.flat
            for p in range(len(ii)):
                a = f[o[ii[p]]:o[ii[p] + 1]]
                b = f[o[jj[p]]:o[jj[p] + 1]]
                out[p] = len(np.intersect1d(a, b, assume_unique=True))
            return out
        fn = (lib.rtc_count_common_u64 if self.use64
              else lib.rtc_count_common_u32)
        ii32 = np.ascontiguousarray(ii, dtype=np.int32)
        jj32 = np.ascontiguousarray(jj, dtype=np.int32)
        fn(self.flat.ctypes.data, self.offs.ctypes.data, ii32.ctypes.data,
           jj32.ctypes.data, len(ii), out.ctypes.data,
           threads or (os.cpu_count() or 1))
        return out


def exact_common_counts(hashes: List[np.ndarray], ii: np.ndarray,
                        jj: np.ndarray, threads: int = 0) -> np.ndarray:
    """Exact |A_i ∩ A_j| for candidate pairs (native two-pointer;
    NumPy fallback)."""
    return CsrSketches(hashes).count_common(ii, jj, threads)
