"""Device-side KSSD sketching — the experimental device sketch path.

Reference hot loop: src/SketchInfo.cpp:1126-1165 (rolling 2-bit encode of
both strands, canonical k-mer = min(fwd, rc), dimension filter via the
shuffled table, compression to dr_tuple).  The reference scans serially
with rolling state; that recurrence is NOT data-dependent — the k-mer
tuple at position i is a pure function of the k bases in its window:

    tup_i = sum_j code[i+j] << 2*(k-1-j)      (disjoint 2-bit fields)
    rvs_i = sum_j (3 ^ code[i+j]) << 2*j

so the device formulation is k shifted elementwise adds over the whole
chunk (unrolled, elementwise, XLA-fused) instead of a serial scan.  The
4*half_k-bit tuples (44 bits at k=21) exceed 32 bits; since every shift is
even, no 2-bit field ever straddles a 32-bit boundary and the tuple splits
into two carry-free uint32 lanes.  Canonical min and the mask/shift algebra
of SketchInfo.cpp:1044-1048,1141-1152 are emulated on (hi, lo) lane pairs
(helpers below), keeping the whole kernel in uint32.

Streaming: ALL records of all genomes concatenate into one flat code
stream with k-1 ``-1`` separators between records, so windows spanning a
record boundary are masked automatically (replicating the reference's
per-record restart) and every compiled shape is independent of record
lengths.  The stream is processed S_ROWS chunks at a time in ONE device
dispatch (lax.scan; rows overlap by k-1 so every window is seen exactly
once), the keep mask is compacted ON DEVICE (two-level nonzero, see
ops.bitmap.compact_mask_two_level), and the kept (hi, lo, position)
triples come back in one fused quantized-prefix pull.  This replaces the
old cadence of 1 dispatch + 3 full-chunk pulls (~9 B/base) per 1M-base
chunk with 1 dispatch + 2 pulls per S_ROWS M bases (~8 B per KEPT
position, i.e. ~4^-drlevel of all positions).  Kept positions map back
to genomes by a searchsorted over genome start offsets.

Bit-exactness: hashes equal native/rtc_native.cpp (and therefore the
reference) exactly; tests cover 32/64-bit params, Ns, lowercase, and
multi-record genomes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..sketch.kssd import BASE_MAP, KssdParams, get_shuffle_table

# default chunk: positions per scan row (bases = CHUNK + k - 1)
CHUNK = 1 << 20
# default scan rows per device dispatch (positions = S_ROWS * CHUNK)
S_ROWS = 16


# ---------------------------------------------------------------------
# (hi, lo) uint32 lane-pair helpers for the <=64-bit tuple algebra.
# All shifts/masks are Python-int constants at trace time.

def _pair_and(a, mask: int):
    import jax.numpy as jnp
    hi, lo = a
    return (hi & jnp.uint32((mask >> 32) & 0xFFFFFFFF),
            lo & jnp.uint32(mask & 0xFFFFFFFF))


def _pair_or(a, b):
    hi, lo = a
    bhi, blo = b
    return hi | bhi, lo | blo


def _pair_shl(a, s: int):
    """Left shift by a constant (result truncated to 64 bits)."""
    import jax.numpy as jnp
    hi, lo = a
    if s == 0:
        return a
    if s >= 64:
        z = jnp.zeros_like(lo)
        return z, z
    if s >= 32:
        return (lo << jnp.uint32(s - 32)) if s > 32 else lo, \
            jnp.zeros_like(lo)
    return (hi << jnp.uint32(s)) | (lo >> jnp.uint32(32 - s)), \
        lo << jnp.uint32(s)


def _pair_shr(a, s: int):
    import jax.numpy as jnp
    hi, lo = a
    if s == 0:
        return a
    if s >= 64:
        z = jnp.zeros_like(lo)
        return z, z
    if s >= 32:
        return jnp.zeros_like(hi), \
            (hi >> jnp.uint32(s - 32)) if s > 32 else hi
    return hi >> jnp.uint32(s), \
        (lo >> jnp.uint32(s)) | (hi << jnp.uint32(32 - s))


def _pair_lt(a, b):
    hi, lo = a
    bhi, blo = b
    return (hi < bhi) | ((hi == bhi) & (lo < blo))


def _pair_where(c, a, b):
    import jax.numpy as jnp
    return jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1])


# ---------------------------------------------------------------------

def _chunk_kernel(codes, table, p: KssdParams):
    """codes: (C + k - 1,) int32 (-1 = invalid); returns per-position
    (dr_hi, dr_lo, keep) for the C windows starting at each position."""
    import jax.numpy as jnp

    k = p.kmer_size
    n_pos = codes.shape[0] - (k - 1)
    u = codes.astype(jnp.uint32)
    z = jnp.zeros(n_pos, dtype=jnp.uint32)
    tup = (z, z)
    rvs = (z, z)
    valid = jnp.ones(n_pos, dtype=bool)
    for j in range(k):
        c = u[j:j + n_pos]
        vj = codes[j:j + n_pos] >= 0
        valid &= vj
        cc = jnp.where(vj, c, 0)
        s_f = 2 * (k - 1 - j)
        s_r = 2 * j
        # disjoint 2-bit fields: plain OR into the right lane
        if s_f >= 32:
            tup = (tup[0] | (cc << jnp.uint32(s_f - 32)), tup[1])
        else:
            tup = (tup[0], tup[1] | (cc << jnp.uint32(s_f)))
        rc = cc ^ jnp.uint32(3)
        rc = jnp.where(vj, rc, 0)
        if s_r >= 32:
            rvs = (rvs[0] | (rc << jnp.uint32(s_r - 32)), rvs[1])
        else:
            rvs = (rvs[0], rvs[1] | (rc << jnp.uint32(s_r)))
    uni = _pair_where(_pair_lt(tup, rvs), tup, rvs)
    # dim id = middle half_subk-nt context (domask bits)
    hol2 = 2 * (p.half_k - p.half_subk)
    dim = _pair_shr(_pair_and(uni, p.domask), hol2)
    dim_id = dim[1].astype(jnp.int32)  # < 16^half_subk <= 2^24
    pf = jnp.take(table, jnp.where(valid, dim_id, 0))
    keep = valid & (pf >= 0) & (pf < p.dim_end)
    # dr_tuple = ((uni & undomask0) | ((uni & undomask1) << shift1))
    #            >> 4*drlevel, OR shuffle rank (SketchInfo.cpp:1044-1048)
    shift1 = 2 * p.kmer_size - 4 * (p.half_k - p.half_subk)
    dr = _pair_shr(
        _pair_or(_pair_and(uni, p.undomask0),
                 _pair_shl(_pair_and(uni, p.undomask1), shift1)),
        4 * p.drlevel)
    dr = _pair_or(dr, (jnp.zeros_like(dr[0]), pf.astype(jnp.uint32)))
    return dr[0], dr[1], keep


def _stream_kernel_fn(codes2d, table, p: KssdParams, cap: int):
    """ONE dispatch over S scan rows of C chunk positions each.

    codes2d: (S, C + k - 1) int8 (-1 = invalid; rows overlap by k-1).
    Returns (1 + S*cap, 3) uint32: row 0 = [total, max_row_count, 0];
    rows 1.. = (hi, lo, enc) of the kept windows, valid prefix = total,
    enc = row * C + position-in-row (garbage-slot overwrite trick of
    ops.bitmap._batched_filter_fn: each row writes its cap-wide compacted
    block at the running total, so entries past a row's count are
    overwritten by the next row or fall beyond the final total)."""
    import jax
    import jax.numpy as jnp

    from .bitmap import compact_mask_two_level

    s_rows = codes2d.shape[0]
    n_pos = codes2d.shape[1] - (p.kmer_size - 1)
    buf = jnp.zeros((s_rows * cap, 3), dtype=jnp.uint32)

    def body(carry, row):
        buf, total, maxc = carry
        t, codes = row
        hi, lo, keep = _chunk_kernel(codes.astype(jnp.int32), table, p)
        m2 = (keep.reshape(-1, 512) if n_pos % 512 == 0
              else keep.reshape(1, -1))
        count, flat = compact_mask_two_level(m2, cap, cap)
        idx = jnp.maximum(flat, 0)
        enc = (idx + t * jnp.int32(n_pos)).astype(jnp.uint32)
        rows3 = jnp.stack([jnp.take(hi, idx), jnp.take(lo, idx), enc],
                          axis=1)
        buf = jax.lax.dynamic_update_slice(buf, rows3,
                                           (total, jnp.int32(0)))
        return (buf, total + count, jnp.maximum(maxc, count)), None

    (buf, total, maxc), _ = jax.lax.scan(
        body, (buf, jnp.int32(0), jnp.int32(0)),
        (jnp.arange(s_rows, dtype=jnp.int32), codes2d))
    head = jnp.stack([total.astype(jnp.uint32), maxc.astype(jnp.uint32),
                      jnp.uint32(0)])[None]
    return jnp.concatenate([head, buf], axis=0)


@lru_cache(maxsize=16)
def _jitted_stream_kernel(p: KssdParams, s_rows: int, n_codes: int,
                          cap: int):
    import jax

    def fn(codes2d, table):
        return _stream_kernel_fn(codes2d, table, p, cap)

    return jax.jit(fn)


def _encode_codes(seq: bytes) -> np.ndarray:
    return BASE_MAP[np.frombuffer(seq, dtype=np.uint8)].astype(np.int8)


def _pull_quantum(count: int, cap: int) -> int:
    q = 256
    while q < count:
        q *= 4
    return min(q, cap)


def _sketch_stream(records: Iterable[Tuple[int, np.ndarray]],
                   p: KssdParams, chunk: int = CHUNK,
                   s_rows: int = S_ROWS) -> Dict[int, np.ndarray]:
    """Core stream engine: records yields (genome_id, codes int8) in
    nondecreasing genome order; returns {genome_id: kept hashes uint64,
    position order, NON-deduplicated}.  Genomes with no kept windows are
    absent from the result."""
    import jax.numpy as jnp

    k = p.kmer_size
    n_pos = chunk  # positions per scan row
    D = s_rows * n_pos  # positions per dispatch window
    W = D + k - 1  # codes per dispatch window
    # keep rate is ~4^-drlevel of positions (dim_end/dim_size of the
    # shuffle ladder); 4x headroom, regrow-on-overflow for repeat-dense
    # sequences where locally every window lands in kept dims
    cap = max(256, min(n_pos, (4 * n_pos) >> (2 * p.drlevel)))
    table = _device_table(p.half_subk)
    sep = np.full(k - 1, -1, dtype=np.int8)

    parts: List[np.ndarray] = []  # unconsumed stream codes
    avail = 0
    base = 0  # global position of parts[0][0]
    starts: List[int] = []  # global start offset per genome (ascending)
    gids: List[int] = []
    last_gid = None
    out: Dict[int, List[np.ndarray]] = {}
    pending = None  # (window_base, fused_dev, cap_used, window)

    def dispatch(window: np.ndarray, wbase: int, use_cap: int):
        kern = _jitted_stream_kernel(p, s_rows, n_pos + k - 1, use_cap)
        rows = np.lib.stride_tricks.as_strided(
            window, shape=(s_rows, n_pos + k - 1),
            strides=(window.strides[0] * n_pos, window.strides[0]))
        fused = kern(jnp.asarray(np.ascontiguousarray(rows)), table)
        try:  # start the 12-byte head transfer as soon as it's ready
            fused[:1].copy_to_host_async()
        except Exception:
            pass
        return (wbase, fused, use_cap, window)

    def collect(pend):
        wbase, fused, use_cap, window = pend
        head = np.asarray(fused[:1])[0]
        total, maxc = int(head[0]), int(head[1])
        while maxc > use_cap:  # overflow: redispatch this window bigger
            use_cap *= 4
            _, fused, use_cap, window = dispatch(window, wbase, use_cap)
            head = np.asarray(fused[:1])[0]
            total, maxc = int(head[0]), int(head[1])
        if not total:
            return
        q = _pull_quantum(total, s_rows * use_cap)
        data = np.asarray(fused[1:1 + q])[:total]
        hi = data[:, 0].astype(np.uint64)
        lo = data[:, 1].astype(np.uint64)
        pos = wbase + data[:, 2].astype(np.int64)
        hashes = (hi << np.uint64(32)) | lo
        # positions ascend and genomes are stream-ordered, so genome ids
        # are nondecreasing: one searchsorted + boundary split attributes
        # every kept window
        g_of = np.searchsorted(np.asarray(starts, dtype=np.int64), pos,
                               side="right") - 1
        cut = np.flatnonzero(np.diff(g_of)) + 1
        bounds = np.r_[0, cut, len(pos)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            gid = gids[int(g_of[a])]
            out.setdefault(gid, []).append(hashes[a:b])

    def flush(final: bool = False):
        nonlocal parts, avail, base, pending
        if not parts:
            return
        stream = np.concatenate(parts) if len(parts) > 1 else parts[0]
        while len(stream) >= W or (final and len(stream)):
            window = stream[:W]
            if len(window) < W:
                window = np.concatenate(
                    [window, np.full(W - len(window), -1, dtype=np.int8)])
            nxt = dispatch(window, base, cap)  # pipeline: dispatch next...
            if pending is not None:
                collect(pending)  # ...before pulling the previous window
            pending = nxt
            stream = stream[D:]
            base += D
        parts = [stream] if len(stream) else []
        avail = len(stream)

    for gid, codes in records:
        if gid != last_gid:
            if last_gid is not None:
                parts.append(sep)
                avail += len(sep)
            starts.append(base + avail)
            gids.append(gid)
            last_gid = gid
        else:
            parts.append(sep)  # record boundary within a genome
            avail += len(sep)
        parts.append(codes)
        avail += len(codes)
        if avail >= W:
            flush()
    if avail:
        flush(final=True)
    if pending is not None:
        collect(pending)
    return {g: np.concatenate(v) for g, v in out.items()}


def device_kmer_hashes(seq: bytes, p: KssdParams,
                       chunk: int = CHUNK) -> np.ndarray:
    """All kept (non-deduplicated) KSSD hashes of one sequence as uint64 —
    the device twin of sketch.kssd.kssd_kmer_hashes_numpy, bit-identical."""
    if len(seq) < p.kmer_size:
        return np.empty(0, dtype=np.uint64)
    res = _sketch_stream([(0, _encode_codes(seq))], p, chunk=chunk,
                         s_rows=min(S_ROWS, max(1, -(-len(seq) // chunk))))
    return res.get(0, np.empty(0, dtype=np.uint64))


@lru_cache(maxsize=4)
def _device_table(half_subk: int):
    import jax.numpy as jnp

    from ..utils.jaxcfg import configure_jax
    configure_jax()
    return jnp.asarray(get_shuffle_table(half_subk))


def sketch_kssd_device(genomes: List[List[bytes]], p: KssdParams,
                       chunk: int = CHUNK,
                       s_rows: int = S_ROWS) -> List[np.ndarray]:
    """Device-sketch a batch of genomes (each = list of record sequences).

    All genomes ride ONE code stream (records within and across genomes
    separated by k-1 invalid codes), so the whole batch costs
    ceil(total_bases / (s_rows*chunk)) pipelined dispatches.  Returns
    per-genome sorted deduplicated hash arrays (uint64 if p.use64 else
    uint32) bit-identical to the native/NumPy sketchers."""
    def gen():
        for gid, records in enumerate(genomes):
            for s in records:
                yield gid, _encode_codes(s)

    res = _sketch_stream(gen(), p, chunk=chunk, s_rows=s_rows)
    empty = np.empty(0, dtype=np.uint64)
    out = []
    for gid in range(len(genomes)):
        h = np.unique(res.get(gid, empty))
        out.append(h if p.use64 else h.astype(np.uint32))
    return out


def sketch_files_kssd_device(files, min_len: int, kmer_size: int,
                             drlevel: int, chunk: int = CHUNK,
                             s_rows: int = S_ROWS
                             ) -> Tuple[object, KssdParams]:
    """Device-sketch a list of FASTA(.gz) files — drop-in equivalent of
    sketch.kssd.sketch_files_kssd (same SketchSet contents).

    Files stream through the SHARED code stream (one pipelined dispatch
    per s_rows*chunk bases across file boundaries); host memory is
    bounded by one dispatch window plus one file's records."""
    from ..io.fasta import read_fasta
    from ..sketch.base import SketchSet

    p = KssdParams.from_kmer_size(kmer_size, drlevel)
    ss = SketchSet("kssd", p, True, p.use64)
    metas = []  # (file, name, comment, seq0_len, total, num_seqs)

    def gen():
        for f in files:
            records = list(read_fasta(f))
            total = sum(len(s) for _, _, s in records)
            if total < min_len or not records:
                continue
            gid = len(metas)
            name, comment, seq0 = records[0]
            metas.append((f, name or "noName", comment or "noName",
                          len(seq0), total, len(records)))
            for _, _, s in records:
                yield gid, _encode_codes(s)

    res = _sketch_stream(gen(), p, chunk=chunk, s_rows=s_rows)
    empty = np.empty(0, dtype=np.uint64)
    for gid, (f, name, comment, s0, total, nseq) in enumerate(metas):
        h = np.unique(res.get(gid, empty))
        ss.append_genome(
            file_name=f, name=name, comment=comment, seq0_len=s0,
            total_len=total, num_seqs=nseq,
            hashes=h if p.use64 else h.astype(np.uint32))
    return ss, p
