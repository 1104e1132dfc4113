"""rabbittclust_tpu — GPU-accelerated genome clustering framework.

A from-scratch JAX re-design of the capabilities of
RabbitBio/RabbitTClust: k-mer sketching (KSSD / MinHash), sketch-distance
estimation (Mash / AAF containment), and large-scale clustering
(single-linkage-over-MST, greedy incremental, Louvain/Leiden, DBSCAN) with
persistence, incremental append, and representative databases.

Layer map (mirrors SURVEY.md §7):
    io/        host streaming FASTA ingest, genome metadata
    sketch/    KSSD + MinHash sketch builders (native C++ fast path)
    ops/       JAX device engines and the Triton pair-count kernel
    index/     inverted indexes (host + CSR device form)
    distance/  Mash / AAF distance math
    cluster/   MST, greedy, leiden, dbscan engines + postprocess
    state/     persistence formats, RepDB / cluster states, append
    parallel/  device mesh, sharded distance tiles, collective merge
    cli/       clust-mst / clust-greedy / clust-leiden / clust-dbscan
    utils/     glibc rand emulation, native bindings, timers
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large freed buffers on the glibc heap for reuse.

    By default glibc mmaps every allocation over 128 KB and munmaps it on
    free, so each reuse re-faults the pages — and first-touch faults on
    this virtualized kernel cost a measured ~6-9 s per GB (a warm 1 GB
    copy is 0.13 s).  Raising M_MMAP_THRESHOLD keeps multi-GB sketch /
    CSR / pack buffers on the heap, where the next same-sized allocation
    reuses already-faulted memory (measured: repeat 1 GB CSR flatten
    7.7 s -> 0.8 s).  Trades peak RSS retention for wall time;
    RTC_MALLOC_REUSE=0 restores the default behavior."""
    import os as _os
    if _os.environ.get("RTC_MALLOC_REUSE", "1") == "0":
        return
    try:
        import ctypes as _ct
        _libc = _ct.CDLL("libc.so.6", use_errno=True)
        _libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()
