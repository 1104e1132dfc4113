"""Greedy cluster state + RepDB (representative database).

Re-derivation of reference KssdClusterState / MinHashClusterState
(src/greedy.h:47-123, src/greedy.cpp:1545-2780):

  * full state -> ``cluster_state.bin`` for --append incremental clustering
    (binary-compatible with the reference layout, KSSI02 index marker);
  * compact RepDB -> ``REPDB002`` files for read-only --query / --assign /
    --stats verbs;
  * incremental clustering: probe rep index, size-ratio + common filters,
    exact min-distance assignment (<= threshold) else new representative
    (src/greedy.cpp:1736-1904).
"""

from __future__ import annotations

import math
import struct
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..sketch.base import SketchSet
from ..sketch.kssd import KssdParams


def exact_containment_distance(a: np.ndarray, b: np.ndarray,
                               kmer_size: int) -> float:
    """AAF containment distance from sorted hash arrays, clamped <= 1."""
    common = len(np.intersect1d(a, b, assume_unique=True))
    mn = min(len(a), len(b))
    c = common / mn if mn else 0.0
    if c >= 1.0:
        return 0.0
    if c <= 0.0:
        return 1.0
    return min(-math.log(c) / kmer_size, 1.0)


def exact_mash_distance(a: np.ndarray, b: np.ndarray, kmer_size: int) -> float:
    """Exact Mash distance from sorted hash arrays, clamped to <= 1
    (reference calculate_mash_distance, greedy.cpp:103-160)."""
    common = len(np.intersect1d(a, b, assume_unique=True))
    denom = len(a) + len(b) - common
    j = common / denom if denom else 0.0
    if j == 1.0:
        return 0.0
    if j == 0.0:
        return 1.0
    d = -math.log(2 * j / (1.0 + j)) / kmer_size
    return min(d, 1.0)


def _write_repdb_scale_index_clusters(w, total, n_reps, clusters,
                                      inverted_index) -> None:
    """Shared [Scale]/[Inverted Index]/[Cluster Size Distribution] body of
    the reference RepDB stats reports (greedy.cpp:2673-2730,3073-3128)."""
    w("[Scale]\n")
    w(f"  Total genomes:          {total}\n")
    w(f"  Representatives:        {n_reps}\n")
    w(f"  Clusters:               {len(clusters)}\n")
    compression = (1.0 - n_reps / total) * 100.0 if total > 0 else 0.0
    w(f"  Compression ratio:      {compression:.2f}%\n")
    w("\n")
    w("[Inverted Index]\n")
    w(f"  Unique hashes:          {len(inverted_index)}\n")
    tp = sum(len(v) for v in inverted_index.values())
    mp = max((len(v) for v in inverted_index.values()), default=0)
    avg = tp / len(inverted_index) if inverted_index else 0.0
    w(f"  Total postings:         {tp}\n")
    w(f"  Avg posting length:     {avg:.2f}\n")
    w(f"  Max posting length:     {mp}\n")
    w("\n")
    w("[Cluster Size Distribution]\n")
    if clusters:
        sizes = sorted(len(c) for c in clusters)
        mean = total / len(clusters)
        median = sizes[len(sizes) // 2]
        singleton = sum(1 for s in sizes if s <= 1)
        w(f"  Min cluster size:       {sizes[0]}\n")
        w(f"  Max cluster size:       {sizes[-1]}\n")
        w(f"  Mean cluster size:      {mean:.2f}\n")
        w(f"  Median cluster size:    {median}\n")
        w(f"  Singletons:             {singleton} "
          f"({100.0 * singleton / len(clusters):.1f}%)\n")
        p90 = sizes[min(int(len(sizes) * 0.9), len(sizes) - 1)]
        p95 = sizes[min(int(len(sizes) * 0.95), len(sizes) - 1)]
        p99 = sizes[min(int(len(sizes) * 0.99), len(sizes) - 1)]
        w(f"  P90 cluster size:       {p90}\n")
        w(f"  P95 cluster size:       {p95}\n")
        w(f"  P99 cluster size:       {p99}\n")


@dataclass
class KssdClusterState:
    params: KssdParams
    threshold: float
    kmer_size: int
    representative_ids: List[int] = field(default_factory=list)
    clusters: List[List[int]] = field(default_factory=list)
    # all_sketches metadata (parallel arrays over genome id)
    file_names: List[str] = field(default_factory=list)
    total_lens: List[int] = field(default_factory=list)
    hashes: List[np.ndarray] = field(default_factory=list)
    use64: bool = False
    inverted_index: Dict[int, List[int]] = field(default_factory=dict)
    # names/comments for printing (not in the reference binary format; kept
    # in memory when built fresh, reconstructed as fileName otherwise)
    names: Optional[List[str]] = None
    comments: Optional[List[str]] = None

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_clustering(cls, ss: SketchSet, p: KssdParams, gres,
                        threshold: float) -> "KssdClusterState":
        st = cls(params=p, threshold=threshold, kmer_size=p.kmer_size,
                 use64=ss.use64)
        st.file_names = list(ss.file_names)
        st.total_lens = list(ss.total_lens)
        st.hashes = list(ss.hashes)
        st.names = list(ss.names)
        st.comments = list(ss.comments)
        st.clusters = [list(c) for c in gres.clusters]
        st.representative_ids = [c[0] for c in st.clusters if c]
        st.build_inverted_index()
        return st

    def build_inverted_index(self) -> None:
        self.inverted_index = {}
        for rep_idx, gid in enumerate(self.representative_ids):
            self._index_add(rep_idx, self.hashes[gid])

    def _index_add(self, rep_idx: int, h: np.ndarray) -> None:
        idx = self.inverted_index
        for hv in h.tolist():
            lst = idx.get(hv)
            if lst is None:
                idx[hv] = [rep_idx]
            else:
                lst.append(rep_idx)

    # ---- incremental clustering (reference KssdIncrementalCluster) -------

    def incremental_cluster(self, new_ss: SketchSet) -> List[List[int]]:
        radio = 2.0 * math.exp(self.threshold * self.kmer_size) - 1.0
        x = math.exp(-self.threshold * self.kmer_size)
        j_min = x / (2.0 - x)
        start = len(self.hashes)
        self.file_names.extend(new_ss.file_names)
        self.total_lens.extend(new_ss.total_lens)
        self.hashes.extend(new_ss.hashes)
        if self.names is None:
            # loaded states carry no sequence names: old members print N/A,
            # freshly appended genomes keep their real names (reference
            # printKssdResult over mixed state.all_sketches)
            self.names = ["N/A"] * start
            self.comments = ["N/A"] * start
        self.names.extend(new_ss.names)
        self.comments.extend(new_ss.comments)
        for k in range(len(new_ss)):
            gid = start + k
            h = self.hashes[gid]
            size_qry = len(h)
            counts: Dict[int, int] = {}
            for hv in h.tolist():
                lst = self.inverted_index.get(hv)
                if lst is None:
                    continue
                for r in lst:
                    counts[r] = counts.get(r, 0) + 1
            best_dist = float("inf")
            best_rep = -1
            for rep_idx, common in counts.items():
                rep_gid = self.representative_ids[rep_idx]
                size_ref = len(self.hashes[rep_gid])
                if size_ref == 0:
                    continue
                ratio = size_qry / size_ref
                if ratio > radio or ratio < 1.0 / radio:
                    continue
                # int truncation matches reference greedy.cpp:1828
                if common < int(j_min * (size_qry + size_ref) / (1.0 + j_min)):
                    continue
                dist = exact_mash_distance(self.hashes[rep_gid], h,
                                           self.kmer_size)
                if dist <= self.threshold and (
                        dist < best_dist or
                        (dist == best_dist and
                         (best_rep == -1 or rep_idx < best_rep))):
                    best_dist = dist
                    best_rep = rep_idx
            if best_rep != -1:
                self.clusters[best_rep].append(gid)
            else:
                new_rep_idx = len(self.representative_ids)
                self.representative_ids.append(gid)
                # reference quirk (greedy.cpp:1864): clusters created during
                # incremental updates start EMPTY — the representative is
                # tracked in representative_ids but absent from the printed
                # member list
                self.clusters.append([])
                self._index_add(new_rep_idx, h)
        return self.clusters

    # ---- query / assign / stats ------------------------------------------

    def query_topk(self, query_hashes: np.ndarray, topk: int):
        radio = 2.0 * math.exp(self.threshold * self.kmer_size) - 1.0
        x = math.exp(-self.threshold * self.kmer_size)
        j_min = x / (2.0 - x)
        size_qry = len(query_hashes)
        counts: Dict[int, int] = {}
        for hv in query_hashes.tolist():
            lst = self.inverted_index.get(hv)
            if lst is None:
                continue
            for r in lst:
                counts[r] = counts.get(r, 0) + 1
        scored = []
        for rep_idx, common in counts.items():
            rep_gid = self.representative_ids[rep_idx]
            size_ref = len(self.hashes[rep_gid])
            if size_ref == 0:
                continue
            ratio = size_qry / size_ref
            if ratio > radio or ratio < 1.0 / radio:
                continue
            if common < int(j_min * (size_qry + size_ref) / (1.0 + j_min)):
                continue
            dist = exact_mash_distance(self.hashes[rep_gid], query_hashes,
                                       self.kmer_size)
            scored.append((dist, rep_idx))
        scored.sort(key=lambda t: (t[0], t[1]))
        out = []
        for dist, rep_idx in scored[:topk]:
            gid = self.representative_ids[rep_idx]
            out.append({
                "rep_idx": rep_idx, "genome_id": gid,
                "genome_name": self.file_names[gid], "distance": dist,
                "cluster_id": rep_idx,
                "cluster_size": len(self.clusters[rep_idx]),
            })
        return out

    def assign(self, query_hashes: np.ndarray):
        res = self.query_topk(query_hashes, 1)
        if res and res[0]["distance"] <= self.threshold:
            return res[0]
        return {"rep_idx": -1, "genome_id": -1, "genome_name": "unassigned",
                "distance": -1.0, "cluster_id": -1, "cluster_size": 0}

    def print_stats(self, out=sys.stdout) -> None:
        """Byte-identical to the reference KssdClusterState::print_stats
        (greedy.cpp:2656-2762)."""
        total = sum(len(c) for c in self.clusters)
        w = out.write
        w("========================================\n")
        w("        RepDB Statistics Report\n")
        w("========================================\n")
        w("\n")
        w("[Basic Info]\n")
        w(f"  Threshold:              {self.threshold:g}\n")
        w(f"  Kmer size:              {self.kmer_size}\n")
        w(f"  KSSD half_k:            {self.params.half_k}\n")
        w(f"  KSSD half_subk:         {self.params.half_subk}\n")
        w(f"  KSSD drlevel:           {self.params.drlevel}\n")
        w("\n")
        _write_repdb_scale_index_clusters(
            w, total, len(self.representative_ids), self.clusters,
            self.inverted_index)
        w("\n")
        w("[Representative Sketch Sizes]\n")
        if self.representative_ids:
            szs = [len(self.hashes[r]) for r in self.representative_ids]
            w(f"  Min sketch size:        {min(szs)}\n")
            w(f"  Max sketch size:        {max(szs)}\n")
            w(f"  Mean sketch size:       {sum(szs) / len(szs):.1f}\n")
        total_seq_len = sum(self.total_lens)
        if total_seq_len > 0:
            rep_seq_len = sum(self.total_lens[r]
                              for r in self.representative_ids)
            w("\n")
            w("[Genome Coverage]\n")
            w(f"  Total sequence length:  {total_seq_len} bp\n")
            w(f"  Representative seq len: {rep_seq_len} bp\n")
            w(f"  Coverage ratio:         "
              f"{100.0 * rep_seq_len / total_seq_len:.2f}%\n")
        w("========================================\n")

    # ---- persistence ------------------------------------------------------

    def _write_index(self, f) -> None:
        f.write(struct.pack("<Q", len(self.inverted_index)))
        for hv in sorted(self.inverted_index):
            lst = self.inverted_index[hv]
            f.write(struct.pack("<Q", hv))
            f.write(struct.pack("<Q", len(lst)))
            f.write(np.asarray(lst, dtype="<i4").tobytes())

    @staticmethod
    def _read_index(data: bytes, off: int, key64: bool):
        (n,) = struct.unpack_from("<Q", data, off); off += 8
        idx: Dict[int, List[int]] = {}
        for _ in range(n):
            if key64:
                (hv,) = struct.unpack_from("<Q", data, off); off += 8
            else:
                (hv,) = struct.unpack_from("<I", data, off); off += 4
            (m,) = struct.unpack_from("<Q", data, off); off += 8
            idx[hv] = np.frombuffer(data, dtype="<i4", count=m,
                                    offset=off).tolist()
            off += 4 * m
        return idx, off

    def save(self, filepath: str) -> None:
        """Full state (cluster_state.bin layout, greedy.cpp:1545-1624)."""
        with open(filepath, "wb") as f:
            f.write(struct.pack("<d", self.threshold))
            f.write(struct.pack("<i", self.kmer_size))
            f.write(struct.pack("<iiii", self.params.half_k,
                                self.params.half_subk, self.params.drlevel,
                                len(self.hashes)))
            f.write(struct.pack("<Q", len(self.representative_ids)))
            f.write(np.asarray(self.representative_ids, dtype="<i4").tobytes())
            f.write(struct.pack("<Q", len(self.hashes)))
            for i, h in enumerate(self.hashes):
                f.write(struct.pack("<i", i))
                f.write(struct.pack("<Q", self.total_lens[i]))
                f.write(struct.pack("<?", self.use64))
                f.write(struct.pack("<I", len(h)))
                h32 = 0 if self.use64 else len(h)
                h64 = len(h) if self.use64 else 0
                f.write(struct.pack("<QQ", h32, h64))
                f.write(np.ascontiguousarray(h).tobytes())
                name = self.file_names[i].encode()
                f.write(struct.pack("<Q", len(name)))
                f.write(name)
            f.write(struct.pack("<Q", len(self.clusters)))
            for cl in self.clusters:
                f.write(struct.pack("<Q", len(cl)))
                f.write(np.asarray(cl, dtype="<i4").tobytes())
            f.write(b"KSSI02\x00\x00")
            self._write_index(f)
        print(f"Saved clustering state to: {filepath}", file=sys.stderr)

    @classmethod
    def load(cls, filepath: str) -> "KssdClusterState":
        with open(filepath, "rb") as f:
            data = f.read()
        off = 0
        (threshold,) = struct.unpack_from("<d", data, off); off += 8
        (kmer_size,) = struct.unpack_from("<i", data, off); off += 4
        hk, hs, dl, _gn = struct.unpack_from("<iiii", data, off); off += 16
        st = cls(params=KssdParams(half_k=hk, half_subk=hs, drlevel=dl),
                 threshold=threshold, kmer_size=kmer_size)
        (nrep,) = struct.unpack_from("<Q", data, off); off += 8
        st.representative_ids = np.frombuffer(
            data, dtype="<i4", count=nrep, offset=off).tolist()
        off += 4 * nrep
        (nsk,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(nsk):
            off += 4  # id
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            (u64,) = struct.unpack_from("<?", data, off); off += 1
            off += 4  # sketchsize
            h32, h64 = struct.unpack_from("<QQ", data, off); off += 16
            if h32:
                h = np.frombuffer(data, dtype="<u4", count=h32, offset=off).copy()
                off += 4 * h32
            else:
                h = np.frombuffer(data, dtype="<u8", count=h64, offset=off).copy()
                off += 8 * h64
            (nl,) = struct.unpack_from("<Q", data, off); off += 8
            name = data[off:off + nl].decode("utf-8", "replace"); off += nl
            st.hashes.append(h)
            st.total_lens.append(tl)
            st.file_names.append(name)
            st.use64 = bool(u64)
        (ncl,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(ncl):
            (m,) = struct.unpack_from("<Q", data, off); off += 8
            st.clusters.append(np.frombuffer(
                data, dtype="<i4", count=m, offset=off).tolist())
            off += 4 * m
        key64 = data[off:off + 6] == b"KSSI02"
        if key64:
            off += 8
        st.inverted_index, off = cls._read_index(data, off, key64)
        print(f"Loaded clustering state from: {filepath}", file=sys.stderr)
        return st

    def save_repdb(self, filepath: str) -> None:
        """Compact RepDB (REPDB002 layout, greedy.cpp:2351-2428)."""
        with open(filepath, "wb") as f:
            f.write(b"REPDB002")
            f.write(struct.pack("<d", self.threshold))
            f.write(struct.pack("<i", self.kmer_size))
            f.write(struct.pack("<iiii", self.params.half_k,
                                self.params.half_subk, self.params.drlevel,
                                len(self.hashes)))
            f.write(struct.pack("<Q", len(self.representative_ids)))
            for rep_idx, gid in enumerate(self.representative_ids):
                f.write(struct.pack("<i", gid))
                h = self.hashes[gid]
                f.write(struct.pack("<i", gid))
                f.write(struct.pack("<Q", self.total_lens[gid]))
                f.write(struct.pack("<?", self.use64))
                f.write(struct.pack("<I", len(h)))
                h32 = 0 if self.use64 else len(h)
                h64 = len(h) if self.use64 else 0
                f.write(struct.pack("<QQ", h32, h64))
                f.write(np.ascontiguousarray(h).tobytes())
                name = self.file_names[gid].encode()
                f.write(struct.pack("<Q", len(name)))
                f.write(name)
            f.write(struct.pack("<Q", len(self.clusters)))
            for cl in self.clusters:
                f.write(struct.pack("<Q", len(cl)))
                f.write(np.asarray(cl, dtype="<i4").tobytes())
            f.write(struct.pack("<Q", len(self.hashes)))
            for i in range(len(self.hashes)):
                name = self.file_names[i].encode()
                f.write(struct.pack("<Q", len(name)))
                f.write(name)
                f.write(struct.pack("<Q", self.total_lens[i]))
            self._write_index(f)
        print(f"RepDB saved to: {filepath}", file=sys.stderr)

    @classmethod
    def load_repdb(cls, filepath: str) -> "KssdClusterState":
        with open(filepath, "rb") as f:
            data = f.read()
        magic = data[:8]
        if magic not in (b"REPDB002", b"REPDB001"):
            raise ValueError(f"Invalid RepDB file (bad magic): {filepath}")
        v2 = magic == b"REPDB002"
        off = 8
        (threshold,) = struct.unpack_from("<d", data, off); off += 8
        (kmer_size,) = struct.unpack_from("<i", data, off); off += 4
        hk, hs, dl, _gn = struct.unpack_from("<iiii", data, off); off += 16
        st = cls(params=KssdParams(half_k=hk, half_subk=hs, drlevel=dl),
                 threshold=threshold, kmer_size=kmer_size)
        (nrep,) = struct.unpack_from("<Q", data, off); off += 8
        rep_hashes = {}
        rep_meta = {}
        for _ in range(nrep):
            (gid,) = struct.unpack_from("<i", data, off); off += 4
            off += 4  # sk.id
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            (u64,) = struct.unpack_from("<?", data, off); off += 1
            off += 4
            h32, h64 = struct.unpack_from("<QQ", data, off); off += 16
            if h32:
                h = np.frombuffer(data, dtype="<u4", count=h32, offset=off).copy()
                off += 4 * h32
            else:
                h = np.frombuffer(data, dtype="<u8", count=h64, offset=off).copy()
                off += 8 * h64
            (nl,) = struct.unpack_from("<Q", data, off); off += 8
            name = data[off:off + nl].decode("utf-8", "replace"); off += nl
            st.representative_ids.append(gid)
            rep_hashes[gid] = h
            rep_meta[gid] = (name, tl)
            st.use64 = bool(u64)
        (ncl,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(ncl):
            (m,) = struct.unpack_from("<Q", data, off); off += 8
            st.clusters.append(np.frombuffer(
                data, dtype="<i4", count=m, offset=off).tolist())
            off += 4 * m
        (nall,) = struct.unpack_from("<Q", data, off); off += 8
        for i in range(nall):
            (nl,) = struct.unpack_from("<Q", data, off); off += 8
            name = data[off:off + nl].decode("utf-8", "replace"); off += nl
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            st.file_names.append(name)
            st.total_lens.append(tl)
            st.hashes.append(rep_hashes.get(
                i, np.empty(0, dtype=np.uint64 if st.use64 else np.uint32)))
        st.inverted_index, off = cls._read_index(data, off, v2)
        print(f"RepDB loaded from: {filepath}", file=sys.stderr)
        return st

    # ---- output ----------------------------------------------------------

    def write_cluster_result(self, output_file: str,
                             threshold: Optional[float] = None) -> None:
        from .cluster_io import write_cluster_file
        ss = SketchSet("kssd", self.params, True, self.use64)
        for i in range(len(self.hashes)):
            # a loaded state has no sequence names; the reference prints
            # N/A for empty fileSeqs (printKssdResult, MST_IO.cpp:99-104)
            nm = self.names[i] if self.names else "N/A"
            cm = self.comments[i] if self.comments else "N/A"
            ss.append_genome(file_name=self.file_names[i], name=nm,
                             comment=cm, seq0_len=0,
                             total_len=self.total_lens[i], num_seqs=1,
                             hashes=self.hashes[i])
        write_cluster_file(output_file, self.clusters, ss,
                           -1.0 if threshold is None else threshold)


@dataclass
class MinHashClusterState:
    """MinHash greedy cluster state (reference MinHashClusterState,
    greedy.cpp:2134+; "MINHASH\\0" magic).  Shares the probe/assign logic
    with the KSSD state but carries MinHash parameters and supports the
    containment (-c) similarity."""

    threshold: float
    kmer_size: int
    sketch_size: int
    is_containment: bool = False
    contain_compress: int = 0
    representative_ids: List[int] = field(default_factory=list)
    clusters: List[List[int]] = field(default_factory=list)
    file_names: List[str] = field(default_factory=list)
    total_lens: List[int] = field(default_factory=list)
    hashes: List[np.ndarray] = field(default_factory=list)
    inverted_index: Dict[int, List[int]] = field(default_factory=dict)
    names: Optional[List[str]] = None
    comments: Optional[List[str]] = None

    @classmethod
    def from_clustering(cls, ss: SketchSet, p, gres,
                        threshold: float) -> "MinHashClusterState":
        st = cls(threshold=threshold, kmer_size=p.kmer_size,
                 sketch_size=p.sketch_size,
                 is_containment=p.is_containment,
                 contain_compress=p.contain_compress)
        st.file_names = list(ss.file_names)
        st.total_lens = list(ss.total_lens)
        st.hashes = list(ss.hashes)
        st.names = list(ss.names)
        st.comments = list(ss.comments)
        st.clusters = [list(c) for c in gres.clusters]
        st.representative_ids = [c[0] for c in st.clusters if c]
        st.build_inverted_index()
        return st

    def build_inverted_index(self) -> None:
        self.inverted_index = {}
        for rep_idx, gid in enumerate(self.representative_ids):
            self._index_add(rep_idx, self.hashes[gid])

    def _index_add(self, rep_idx: int, h: np.ndarray) -> None:
        idx = self.inverted_index
        for hv in h.tolist():
            idx.setdefault(hv, []).append(rep_idx)

    def _distance(self, a: np.ndarray, b: np.ndarray) -> float:
        if self.is_containment:
            return exact_containment_distance(a, b, self.kmer_size)
        return exact_mash_distance(a, b, self.kmer_size)

    def incremental_cluster(self, new_ss: SketchSet) -> List[List[int]]:
        x = math.exp(-self.threshold * self.kmer_size)
        j_min = x / (2.0 - x)
        start = len(self.hashes)
        self.file_names.extend(new_ss.file_names)
        self.total_lens.extend(new_ss.total_lens)
        self.hashes.extend(new_ss.hashes)
        if self.names is not None:
            self.names.extend(new_ss.names)
            self.comments.extend(new_ss.comments)
        for k in range(len(new_ss)):
            gid = start + k
            h = self.hashes[gid]
            size_qry = len(h)
            counts: Dict[int, int] = {}
            for hv in h.tolist():
                lst = self.inverted_index.get(hv)
                if lst is None:
                    continue
                for r in lst:
                    counts[r] = counts.get(r, 0) + 1
            best_dist = float("inf")
            best_rep = -1
            for rep_idx, common in counts.items():
                rep_gid = self.representative_ids[rep_idx]
                size_ref = len(self.hashes[rep_gid])
                if size_ref == 0:
                    continue
                # int-truncated common bounds, no size-ratio prefilter
                # (reference MinHashIncrementalCluster, greedy.cpp:2050-2062)
                if self.is_containment:
                    if common < int(j_min * min(size_qry, size_ref)):
                        continue
                else:
                    if common < int(j_min * (size_qry + size_ref) /
                                    (1.0 + j_min)):
                        continue
                dist = self._distance(self.hashes[rep_gid], h)
                if dist <= self.threshold and (
                        dist < best_dist or
                        (dist == best_dist and
                         (best_rep == -1 or rep_idx < best_rep))):
                    best_dist = dist
                    best_rep = rep_idx
            if best_rep != -1:
                self.clusters[best_rep].append(gid)
            else:
                # the new representative is NOT a member of its own cluster
                # (reference quirk: clusters.push_back(empty),
                # greedy.cpp:2099-2103 — same as the KSSD state path)
                new_rep_idx = len(self.representative_ids)
                self.representative_ids.append(gid)
                self.clusters.append([])
                self._index_add(new_rep_idx, h)
        return self.clusters

    def query_topk(self, query_hashes: np.ndarray, topk: int):
        size_qry = len(query_hashes)
        counts: Dict[int, int] = {}
        for hv in query_hashes.tolist():
            lst = self.inverted_index.get(hv)
            if lst is None:
                continue
            for r in lst:
                counts[r] = counts.get(r, 0) + 1
        scored = []
        for rep_idx, common in counts.items():
            rep_gid = self.representative_ids[rep_idx]
            if len(self.hashes[rep_gid]) == 0:
                continue
            dist = self._distance(self.hashes[rep_gid], query_hashes)
            scored.append((dist, rep_idx))
        scored.sort(key=lambda t: (t[0], t[1]))
        out = []
        for dist, rep_idx in scored[:topk]:
            gid = self.representative_ids[rep_idx]
            out.append({
                "rep_idx": rep_idx, "genome_id": gid,
                "genome_name": self.file_names[gid], "distance": dist,
                "cluster_id": rep_idx,
                "cluster_size": len(self.clusters[rep_idx]),
            })
        return out

    def assign(self, query_hashes: np.ndarray):
        res = self.query_topk(query_hashes, 1)
        if res and res[0]["distance"] <= self.threshold:
            return res[0]
        return {"rep_idx": -1, "genome_id": -1, "genome_name": "unassigned",
                "distance": -1.0, "cluster_id": -1, "cluster_size": 0}

    def print_stats(self, out=sys.stdout) -> None:
        """Byte-identical to the reference MinHashClusterState::print_stats
        (greedy.cpp:3057-3147)."""
        total = sum(len(c) for c in self.clusters)
        w = out.write
        w("========================================\n")
        w("    MinHash RepDB Statistics Report\n")
        w("========================================\n")
        w("\n")
        w("[Basic Info]\n")
        w(f"  Threshold:              {self.threshold:g}\n")
        w(f"  Kmer size:              {self.kmer_size}\n")
        w(f"  Sketch size:            {self.sketch_size}\n")
        w(f"  Containment mode:       "
          f"{'yes' if self.is_containment else 'no'}\n")
        w("\n")
        _write_repdb_scale_index_clusters(
            w, total, len(self.representative_ids), self.clusters,
            self.inverted_index)
        total_seq_len = sum(self.total_lens)
        if total_seq_len > 0:
            rep_seq_len = sum(self.total_lens[r]
                              for r in self.representative_ids)
            w("\n")
            w("[Genome Coverage]\n")
            w(f"  Total sequence length:  {total_seq_len} bp\n")
            w(f"  Representative seq len: {rep_seq_len} bp\n")
            w(f"  Coverage ratio:         "
              f"{100.0 * rep_seq_len / total_seq_len:.2f}%\n")
        w("========================================\n")

    # ---- persistence: binary-compatible with the reference --------------
    # full state  = "MINHASH\0"  (MinHashClusterState::save,
    #                             greedy.cpp:2134-2207)
    # RepDB       = "MHREPDB1"   (MinHashClusterState::save_repdb,
    #                             greedy.cpp:2789-2860)
    # contain_compress is NOT persisted by either (reference quirk; the
    # query path only needs per-genome sketch sizes).
    # The inverted index is written in sorted hash order (the reference
    # writes unordered_map iteration order — loaders are order-agnostic).

    def _write_clusters_and_index(self, f) -> None:
        f.write(struct.pack("<Q", len(self.clusters)))
        for cl in self.clusters:
            f.write(struct.pack("<Q", len(cl)))
            f.write(np.asarray(cl, dtype="<i4").tobytes())
        f.write(struct.pack("<Q", len(self.inverted_index)))
        for hv in sorted(self.inverted_index):
            lst = self.inverted_index[hv]
            f.write(struct.pack("<Q", hv))
            f.write(struct.pack("<Q", len(lst)))
            f.write(np.asarray(lst, dtype="<i4").tobytes())

    def save(self, filepath: str) -> None:
        with open(filepath, "wb") as f:
            f.write(b"MINHASH\x00")
            f.write(struct.pack("<dii?", self.threshold, self.kmer_size,
                                self.sketch_size, self.is_containment))
            f.write(struct.pack("<Q", len(self.representative_ids)))
            f.write(np.asarray(self.representative_ids,
                               dtype="<i4").tobytes())
            f.write(struct.pack("<Q", len(self.hashes)))
            for i in range(len(self.hashes)):
                h = self.hashes[i]
                f.write(struct.pack("<i", i))
                f.write(struct.pack("<Q", self.total_lens[i]))
                f.write(struct.pack("<Q", len(h)))
                f.write(np.ascontiguousarray(h, dtype=np.uint64).tobytes())
                name = self.file_names[i].encode()
                f.write(struct.pack("<Q", len(name)))
                f.write(name)
            self._write_clusters_and_index(f)
        print(f"Saved clustering state to: {filepath}", file=sys.stderr)

    def save_repdb(self, filepath: str) -> None:
        with open(filepath, "wb") as f:
            f.write(b"MHREPDB1")
            f.write(struct.pack("<dii?", self.threshold, self.kmer_size,
                                self.sketch_size, self.is_containment))
            f.write(struct.pack("<Q", len(self.representative_ids)))
            for gid in self.representative_ids:
                h = self.hashes[gid]
                f.write(struct.pack("<ii", gid, gid))  # rep id + sketch id
                f.write(struct.pack("<Q", self.total_lens[gid]))
                f.write(struct.pack("<?", self.is_containment))
                f.write(struct.pack("<Q", len(h)))
                f.write(np.ascontiguousarray(h, dtype=np.uint64).tobytes())
                name = self.file_names[gid].encode()
                f.write(struct.pack("<Q", len(name)))
                f.write(name)
            f.write(struct.pack("<Q", len(self.clusters)))
            for cl in self.clusters:
                f.write(struct.pack("<Q", len(cl)))
                f.write(np.asarray(cl, dtype="<i4").tobytes())
            f.write(struct.pack("<Q", len(self.hashes)))
            for i in range(len(self.hashes)):
                name = self.file_names[i].encode()
                f.write(struct.pack("<Q", len(name)))
                f.write(name)
                f.write(struct.pack("<Q", self.total_lens[i]))
            f.write(struct.pack("<Q", len(self.inverted_index)))
            for hv in sorted(self.inverted_index):
                lst = self.inverted_index[hv]
                f.write(struct.pack("<Q", hv))
                f.write(struct.pack("<Q", len(lst)))
                f.write(np.asarray(lst, dtype="<i4").tobytes())
        print(f"MinHash RepDB saved to: {filepath}", file=sys.stderr)

    @staticmethod
    def _load_index(data: bytes, off: int):
        (nh,) = struct.unpack_from("<Q", data, off); off += 8
        idx: Dict[int, List[int]] = {}
        for _ in range(nh):
            (hv,) = struct.unpack_from("<Q", data, off); off += 8
            (m,) = struct.unpack_from("<Q", data, off); off += 8
            idx[hv] = np.frombuffer(
                data, dtype="<i4", count=m, offset=off).tolist()
            off += 4 * m
        return idx, off

    @classmethod
    def load(cls, filepath: str) -> "MinHashClusterState":
        with open(filepath, "rb") as f:
            data = f.read()
        magic = data[:8]
        if magic == b"MHREPDB1":
            return cls._load_repdb_bytes(data, filepath)
        if data[:7] != b"MINHASH":
            raise ValueError(f"bad MinHash state magic in {filepath}")
        off = 8
        threshold, k, ssz, isc = struct.unpack_from("<dii?", data, off)
        off += 17
        st = cls(threshold=threshold, kmer_size=k, sketch_size=ssz,
                 is_containment=bool(isc))
        (nrep,) = struct.unpack_from("<Q", data, off); off += 8
        st.representative_ids = np.frombuffer(
            data, dtype="<i4", count=nrep, offset=off).tolist()
        off += 4 * nrep
        (ntotal,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(ntotal):
            off += 4  # sketch.id (== position)
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            (hn,) = struct.unpack_from("<Q", data, off); off += 8
            st.hashes.append(np.frombuffer(
                data, dtype=np.uint64, count=hn, offset=off).copy())
            off += 8 * hn
            (nl,) = struct.unpack_from("<Q", data, off); off += 8
            st.file_names.append(
                data[off:off + nl].decode("utf-8", "replace")); off += nl
            st.total_lens.append(tl)
        (ncl,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(ncl):
            (m,) = struct.unpack_from("<Q", data, off); off += 8
            st.clusters.append(np.frombuffer(
                data, dtype="<i4", count=m, offset=off).tolist())
            off += 4 * m
        st.inverted_index, off = cls._load_index(data, off)
        print(f"Loaded MinHash state from: {filepath}", file=sys.stderr)
        return st

    @classmethod
    def _load_repdb_bytes(cls, data: bytes,
                          filepath: str) -> "MinHashClusterState":
        off = 8
        threshold, k, ssz, isc = struct.unpack_from("<dii?", data, off)
        off += 17
        st = cls(threshold=threshold, kmer_size=k, sketch_size=ssz,
                 is_containment=bool(isc))
        (nrep,) = struct.unpack_from("<Q", data, off); off += 8
        rep_hashes: Dict[int, np.ndarray] = {}
        for _ in range(nrep):
            (gid,) = struct.unpack_from("<i", data, off); off += 4
            off += 4  # sk.id
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            off += 1  # sk.isContainment
            (hn,) = struct.unpack_from("<Q", data, off); off += 8
            rep_hashes[gid] = np.frombuffer(
                data, dtype=np.uint64, count=hn, offset=off).copy()
            off += 8 * hn
            (nl,) = struct.unpack_from("<Q", data, off); off += 8
            off += nl  # fileName (re-read from the all-genomes table)
            st.representative_ids.append(gid)
        (ncl,) = struct.unpack_from("<Q", data, off); off += 8
        for _ in range(ncl):
            (m,) = struct.unpack_from("<Q", data, off); off += 8
            st.clusters.append(np.frombuffer(
                data, dtype="<i4", count=m, offset=off).tolist())
            off += 4 * m
        (nall,) = struct.unpack_from("<Q", data, off); off += 8
        for i in range(nall):
            (nl,) = struct.unpack_from("<Q", data, off); off += 8
            st.file_names.append(
                data[off:off + nl].decode("utf-8", "replace")); off += nl
            (tl,) = struct.unpack_from("<Q", data, off); off += 8
            st.total_lens.append(tl)
            st.hashes.append(rep_hashes.get(i, np.empty(0, np.uint64)))
        st.inverted_index, off = cls._load_index(data, off)
        print(f"MinHash RepDB loaded from: {filepath}", file=sys.stderr)
        return st

    load_repdb = load

    def write_cluster_result(self, output_file: str,
                             threshold: Optional[float] = None) -> None:
        from .cluster_io import write_cluster_file
        from ..sketch.minhash import MinHashParams
        p = MinHashParams(kmer_size=self.kmer_size,
                          sketch_size=self.sketch_size,
                          is_containment=self.is_containment,
                          contain_compress=self.contain_compress)
        ss = SketchSet("minhash", p, True, True)
        for i in range(len(self.hashes)):
            nm = self.names[i] if self.names else self.file_names[i]
            cm = self.comments[i] if self.comments else ""
            ss.append_genome(file_name=self.file_names[i], name=nm,
                             comment=cm, seq0_len=0,
                             total_len=self.total_lens[i], num_seqs=1,
                             hashes=self.hashes[i])
        write_cluster_file(output_file, self.clusters, ss,
                           -1.0 if threshold is None else threshold)


def batch_query_device(state, query_hashes: List[np.ndarray], topk: int):
    """Device-accelerated batch serving: query many genomes against a
    representative database in one shot.

    The bitmap filter produces a SUPERSET of the reference's candidate
    set (its bounds are strictly looser than query_topk's min-common and
    size-ratio filters), then every surviving (query, rep) pair is re-scored
    with the exact reference criteria — results are identical to calling
    ``state.query_topk`` per query.
    """
    from ..ops.bitmap import candidate_pairs_threshold, CsrSketches

    rep_gids = list(state.representative_ids)
    rep_hashes = [state.hashes[g] for g in rep_gids]
    n_q = len(query_hashes)
    n_r = len(rep_hashes)
    combined = rep_hashes + list(query_hashes)
    ii, jj, _ = candidate_pairs_threshold(
        combined, state.threshold, state.kmer_size, return_shared=True)
    # keep only (query, rep) pairs: reps occupy ids [0, n_r)
    is_qr = (ii >= n_r) & (jj < n_r)
    q_idx = (ii[is_qr] - n_r).astype(np.int64)
    r_idx = jj[is_qr].astype(np.int64)
    csr = CsrSketches(combined)
    common = csr.count_common(ii[is_qr], jj[is_qr])

    radio = 2.0 * math.exp(state.threshold * state.kmer_size) - 1.0
    x = math.exp(-state.threshold * state.kmer_size)
    j_min = x / (2.0 - x)
    per_query = [[] for _ in range(n_q)]
    for q, r, c in zip(q_idx.tolist(), r_idx.tolist(), common.tolist()):
        size_qry = len(query_hashes[q])
        size_ref = len(rep_hashes[r])
        if size_ref == 0:
            continue
        ratio = size_qry / size_ref
        if ratio > radio or ratio < 1.0 / radio:
            continue
        if c < int(j_min * (size_qry + size_ref) / (1.0 + j_min)):
            continue
        d = exact_mash_distance(rep_hashes[r], query_hashes[q],
                                state.kmer_size)
        per_query[q].append((d, r))
    out = []
    for q in range(n_q):
        scored = sorted(per_query[q], key=lambda t: (t[0], t[1]))[:topk]
        out.append([
            {"rep_idx": r, "genome_id": rep_gids[r],
             "genome_name": state.file_names[rep_gids[r]], "distance": d,
             "cluster_id": r, "cluster_size": len(state.clusters[r])}
            for d, r in scored])
    return out
