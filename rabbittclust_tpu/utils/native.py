"""ctypes bindings for the native runtime (native/rtc_native.cpp).

The native library provides the host-side, string/IO-bound components:
glibc-rand shuffle table, KSSD/MinHash sketchers, parallel FASTA ingest,
exact verify and union-find.  It is built from source at first use into
``native/build/librtc_native-<key>.so``, where the key hashes the source and
the compiler flags, so an edit or a flag change builds a fresh library.
Build it ahead of time with ``python -m rabbittclust_tpu.utils.native``.
If it cannot be built, pure-NumPy fallbacks run instead (slower).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
from functools import lru_cache

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_SRC_PATH = os.path.join(_NATIVE_DIR, "rtc_native.cpp")

# Portable flags: no -march=native, so a library built on one host runs on
# any other x86-64 host the checkout is copied to (popcnt is in every
# x86-64 CPU of the last fifteen years).
BUILD_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC") + (
    ("-mpopcnt",) if platform.machine() in ("x86_64", "AMD64") else ())

_c_u64p = ctypes.POINTER(ctypes.c_uint64)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_u32p = ctypes.POINTER(ctypes.c_uint32)


def build_key(source: bytes, flags=BUILD_FLAGS) -> str:
    h = hashlib.sha256(source)
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    with open(_SRC_PATH, "rb") as f:
        key = build_key(f.read())
    return os.path.join(_BUILD_DIR, f"librtc_native-{key}.so")


def build_native(path: str, flags=BUILD_FLAGS) -> None:
    """Compile rtc_native.cpp into ``path``.  The compiler writes a
    temporary file beside it, which ``os.replace`` installs in one step, so
    a concurrent reader never sees a half-written library."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".build-", suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-o", tmp, _SRC_PATH, "-lz"],
                       check=True, capture_output=True, timeout=600)
        os.chmod(tmp, 0o755)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _ensure_built() -> str | None:
    """Path of the current library, building it if needed; None when the
    build fails.  A file lock keeps concurrent processes (test workers)
    from compiling the same library side by side."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            try:
                build_native(path)
            except (OSError, subprocess.SubprocessError) as e:
                err = getattr(e, "stderr", b"") or b""
                print(f"native build failed: {e}\n"
                      f"{err.decode(errors='replace')[-2000:]}",
                      file=sys.stderr)
                return None
    return path


@lru_cache(maxsize=1)
def load_native():
    """Load (building if needed) the native library; None if unavailable."""
    path = _ensure_built()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        print(f"native library failed to load: {e}", file=sys.stderr)
        return None
    # signatures
    lib.rtc_version.restype = ctypes.c_int
    lib.rtc_glibc_rand_stream.argtypes = [ctypes.c_uint32, ctypes.c_int64, _c_u32p]
    lib.rtc_fisher_yates.argtypes = [_c_i32p, ctypes.c_int64, ctypes.c_uint32]
    lib.rtc_generate_shuffle_dim.argtypes = [ctypes.c_int, _c_i32p]
    lib.rtc_sketch_files.restype = ctypes.c_void_p
    lib.rtc_sketch_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _c_i32p, ctypes.c_int,
    ]
    lib.rtc_sketch_sequences.restype = ctypes.c_void_p
    lib.rtc_sketch_sequences.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _c_i32p, ctypes.c_int,
    ]
    lib.rtc_sketch_files_minhash_contain.restype = ctypes.c_void_p
    lib.rtc_sketch_files_minhash_contain.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.rtc_result_count.restype = ctypes.c_int64
    lib.rtc_result_count.argtypes = [ctypes.c_void_p]
    for fn in ("rtc_result_ok",):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    for fn in ("rtc_result_total_len", "rtc_result_seq0_len",
               "rtc_result_num_seqs", "rtc_result_sketch_size",
               "rtc_result_param_size"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.rtc_result_hashes.argtypes = [ctypes.c_void_p, ctypes.c_int64, _c_u64p]
    for fn in ("rtc_result_name", "rtc_result_comment", "rtc_result_file"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.rtc_result_free.argtypes = [ctypes.c_void_p]
    lib.rtc_result_meta.argtypes = [
        ctypes.c_void_p, _c_i32p, _c_i64p, _c_i64p, _c_i64p, _c_i64p,
        _c_i64p]
    lib.rtc_result_strings_len.restype = ctypes.c_int64
    lib.rtc_result_strings_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtc_result_strings.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.rtc_result_hashes_all.argtypes = [ctypes.c_void_p, _c_u64p]
    lib.rtc_kssd_create.restype = ctypes.c_void_p
    lib.rtc_kssd_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, _c_i32p]
    lib.rtc_kssd_reset.argtypes = [ctypes.c_void_p]
    lib.rtc_kssd_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.rtc_kssd_size.restype = ctypes.c_int64
    lib.rtc_kssd_size.argtypes = [ctypes.c_void_p]
    lib.rtc_kssd_extract.argtypes = [ctypes.c_void_p, _c_u64p]
    lib.rtc_kssd_destroy.argtypes = [ctypes.c_void_p]
    lib.rtc_stdsort_size_desc.argtypes = [_c_i64p, ctypes.c_int64, _c_i32p]
    lib.rtc_greedy_minhash.argtypes = [
        _c_u64p, _c_i64p, ctypes.c_int64, _c_i64p, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, _c_i32p]
    lib.rtc_scan_lengths.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, _c_i64p, ctypes.c_int]
    for fn in ("rtc_mst_u32", "rtc_mst_u64"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, _c_i64p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int]
    lib.rtc_mst_edge_count.restype = ctypes.c_int64
    lib.rtc_mst_edge_count.argtypes = [ctypes.c_void_p]
    lib.rtc_mst_edges.argtypes = [ctypes.c_void_p, _c_i32p, _c_i32p,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.rtc_mst_has_dense.restype = ctypes.c_int32
    lib.rtc_mst_has_dense.argtypes = [ctypes.c_void_p]
    lib.rtc_mst_dense.argtypes = [ctypes.c_void_p, _c_i32p, _c_u64p]
    lib.rtc_mst_free.argtypes = [ctypes.c_void_p]
    for fn in ("rtc_count_common_u32", "rtc_count_common_u64"):
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    _c_f64p = ctypes.POINTER(ctypes.c_double)
    lib.rtc_louvain_one_level.restype = ctypes.c_int64
    lib.rtc_louvain_one_level.argtypes = [
        ctypes.c_int64, _c_i64p, _c_i64p, _c_f64p, _c_f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_int64,
        _c_i64p]
    lib.rtc_leiden_refine_moves.argtypes = [
        ctypes.c_int64, _c_i64p, _c_i64p, _c_f64p, _c_f64p,
        ctypes.c_double, _c_i64p, ctypes.c_double, _c_f64p, _c_f64p,
        ctypes.c_void_p, _c_i64p]
    lib.rtc_csr_build.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _c_i64p, _c_i64p, _c_f64p,
        _c_i64p, _c_i64p, _c_f64p, _c_f64p]
    lib.rtc_sort_u64.argtypes = [_c_u64p, ctypes.c_int64, ctypes.c_int]
    lib.rtc_pack_postings_u32.argtypes = [_c_u32p, _c_i64p, ctypes.c_int64,
                                          _c_u64p, ctypes.c_int]
    lib.rtc_unpack_postings_u32.argtypes = [_c_u64p, ctypes.c_int64,
                                            _c_u32p, _c_u32p, ctypes.c_int]
    for fn in ("rtc_intra_mst_u32", "rtc_intra_mst_u64"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, _c_i64p, ctypes.c_int64, _c_i32p,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, _c_i32p,
            ctypes.c_int]
    return lib


def flatten_csr(hashes, use64: bool):
    """(flat, offs) CSR flatten of per-genome hash arrays — parallel
    native gather (rtc_flatten) when the arrays are uniform/contiguous,
    np.concatenate otherwise."""
    dt = np.uint64 if use64 else np.uint32
    n = len(hashes)
    offs = np.zeros(n + 1, dtype=np.int64)
    if not n:
        return np.empty(0, dtype=dt), offs
    np.cumsum([len(h) for h in hashes], out=offs[1:])
    lib = load_native()
    if lib is not None and all(
            h.dtype == dt and h.flags.c_contiguous for h in hashes):
        flat = np.empty(int(offs[-1]), dtype=dt)
        ptrs = np.fromiter((h.ctypes.data for h in hashes),
                           dtype=np.uint64, count=n)
        lib.rtc_flatten.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int]
        lib.rtc_flatten(ptrs.ctypes.data, offs.ctypes.data, n,
                        dt().itemsize, flat.ctypes.data,
                        os.cpu_count() or 1)
        return flat, offs
    return np.concatenate(hashes).astype(dt), offs


def native_mst(hashes, threshold: float, kmer_size: int,
               is_containment: bool, start_index: int, with_dense: bool,
               threads: int):
    """Run the native MST engine over CSR sketches; returns
    (edges(i,j,d), dense|None, ani|None) or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    n = len(hashes)
    use64 = n > 0 and hashes[0].dtype == np.uint64
    flat, offs = flatten_csr(hashes, use64)
    fn = lib.rtc_mst_u64 if use64 else lib.rtc_mst_u32
    h = fn(flat.ctypes.data, offs.ctypes.data_as(_c_i64p), n,
           float(threshold), int(kmer_size), int(is_containment),
           int(start_index), int(with_dense), int(threads))
    try:
        m = int(lib.rtc_mst_edge_count(h))
        ei = np.empty(m, dtype=np.int32)
        ej = np.empty(m, dtype=np.int32)
        ed = np.empty(m, dtype=np.float64)
        if m:
            lib.rtc_mst_edges(h, ei.ctypes.data_as(_c_i32p),
                              ej.ctypes.data_as(_c_i32p),
                              ed.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_double)))
        dense = ani = None
        if with_dense and lib.rtc_mst_has_dense(h):
            dense = np.empty(100 * n, dtype=np.int32)
            ani = np.empty(101, dtype=np.uint64)
            lib.rtc_mst_dense(h, dense.ctypes.data_as(_c_i32p),
                              ani.ctypes.data_as(_c_u64p))
            dense = dense.reshape(100, n).astype(np.int64)
            ani = ani.astype(np.int64)
        return ((ei.astype(np.int64), ej.astype(np.int64), ed), dense, ani)
    finally:
        lib.rtc_mst_free(h)


def native_intra_mst(hashes, labels, threshold: float, kmer_size: int,
                     is_containment: bool, abort_on_cross: bool = False):
    """Intra-partition -t 1 cadence replay (rtc_intra_mst_*): the MST of
    each cluster's internal candidate edges, in the reference's final edge
    order — cut at the threshold this yields the byte-identical
    generateClusterWithBfs member order for a known-exact partition.
    Returns (edges (i, j, d), has_cross) — ``has_cross`` False certifies
    the replay byte-identical to the global -t 1 engine (no hash shared
    across clusters) — or None if the native library is unavailable.
    ``abort_on_cross`` returns empty edges immediately when the
    certificate fails (the caller reruns the full global engine)."""
    lib = load_native()
    if lib is None:
        return None
    n = len(hashes)
    use64 = n > 0 and hashes[0].dtype == np.uint64
    flat, offs = flatten_csr(hashes, use64)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    has_cross = np.zeros(1, dtype=np.int32)
    fn = lib.rtc_intra_mst_u64 if use64 else lib.rtc_intra_mst_u32
    h = fn(flat.ctypes.data, offs.ctypes.data_as(_c_i64p), n,
           labels.ctypes.data_as(_c_i32p), float(threshold),
           int(kmer_size), int(is_containment),
           has_cross.ctypes.data_as(_c_i32p), int(abort_on_cross))
    try:
        m = int(lib.rtc_mst_edge_count(h))
        ei = np.empty(m, dtype=np.int32)
        ej = np.empty(m, dtype=np.int32)
        ed = np.empty(m, dtype=np.float64)
        if m:
            lib.rtc_mst_edges(h, ei.ctypes.data_as(_c_i32p),
                              ej.ctypes.data_as(_c_i32p),
                              ed.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_double)))
        return ((ei.astype(np.int64), ej.astype(np.int64), ed),
                bool(has_cross[0]))
    finally:
        lib.rtc_mst_free(h)


def have_native() -> bool:
    return load_native() is not None


def make_file_array(files):
    arr = (ctypes.c_char_p * len(files))()
    keep = [os.fsencode(f) for f in files]
    for i, b in enumerate(keep):
        arr[i] = b
    return arr, keep


class SketchResultHandle:
    """RAII wrapper over a native SketchResult*."""

    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __len__(self):
        return int(self._lib.rtc_result_count(self._ptr))

    def genome(self, i: int):
        lib, p = self._lib, self._ptr
        n = int(lib.rtc_result_sketch_size(p, i))
        hashes = np.empty(n, dtype=np.uint64)
        if n:
            lib.rtc_result_hashes(p, i, hashes.ctypes.data_as(_c_u64p))
        return {
            "ok": bool(lib.rtc_result_ok(p, i)),
            "file": os.fsdecode(lib.rtc_result_file(p, i) or b""),
            "name": (lib.rtc_result_name(p, i) or b"").decode("utf-8", "replace"),
            "comment": (lib.rtc_result_comment(p, i) or b"").decode("utf-8", "replace"),
            "seq0_len": int(lib.rtc_result_seq0_len(p, i)),
            "total_len": int(lib.rtc_result_total_len(p, i)),
            "num_seqs": int(lib.rtc_result_num_seqs(p, i)),
            "param_size": int(lib.rtc_result_param_size(p, i)),
            "hashes": hashes,
        }

    def bulk(self):
        """One-call-per-field extraction of the whole result set (the
        per-genome accessor loop costs ~0.5 s at 10k genomes).  Returns a
        dict of arrays/lists: ok, seq0_len, total_len, num_seqs,
        param_size, plus per-genome ``hashes`` views (uint64) into one
        flat buffer and decoded name/comment/file lists."""
        lib, p = self._lib, self._ptr
        n = len(self)
        ok = np.empty(n, dtype=np.int32)
        seq0 = np.empty(n, dtype=np.int64)
        total = np.empty(n, dtype=np.int64)
        nseq = np.empty(n, dtype=np.int64)
        psize = np.empty(n, dtype=np.int64)
        ssize = np.empty(n, dtype=np.int64)
        lib.rtc_result_meta(p, ok.ctypes.data_as(_c_i32p),
                            seq0.ctypes.data_as(_c_i64p),
                            total.ctypes.data_as(_c_i64p),
                            nseq.ctypes.data_as(_c_i64p),
                            psize.ctypes.data_as(_c_i64p),
                            ssize.ctypes.data_as(_c_i64p))
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ssize, out=offs[1:])
        flat = np.empty(int(offs[-1]), dtype=np.uint64)
        if len(flat):
            lib.rtc_result_hashes_all(p, flat.ctypes.data_as(_c_u64p))
        strs = []
        for field in range(3):
            ln = int(lib.rtc_result_strings_len(p, field))
            buf = np.empty(ln, dtype=np.uint8)
            if ln:
                lib.rtc_result_strings(p, field, buf.ctypes.data)
            parts = buf.tobytes().split(b"\0")[:n]
            strs.append(parts)
        return {
            "ok": ok, "seq0_len": seq0, "total_len": total,
            "num_seqs": nseq, "param_size": psize, "offs": offs,
            "flat_hashes": flat,
            "names": [b.decode("utf-8", "replace") for b in strs[0]],
            "comments": [b.decode("utf-8", "replace") for b in strs[1]],
            "files": [os.fsdecode(b) for b in strs[2]],
        }

    def __del__(self):
        try:
            if self._ptr:
                self._lib.rtc_result_free(self._ptr)
                self._ptr = None
        except Exception:
            pass


if __name__ == "__main__":
    lib_path = _ensure_built()
    if lib_path is None:
        sys.exit(1)
    print(lib_path, " ".join(BUILD_FLAGS))
