"""Streaming by-sequence ingest: bounded memory + order/results unchanged.

The reference streams single-FASTA inputs through a 16 MB chunk pool
(SketchInfo.cpp:498-503,582-594); our native rtc_sketch_sequences now uses
a byte-bounded producer/consumer (RTC_SEQ_QUEUE_BYTES) instead of slurping
the file."""

import os
import subprocess
import sys

import numpy as np
import pytest


def _write_fasta(path, n_seqs, seq_len, seed=11):
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n_seqs):
            f.write(b">seq%d c%d\n" % (i, i % 7))
            row = lut[rng.integers(0, 4, size=seq_len)].tobytes()
            for ofs in range(0, seq_len, 80):
                f.write(row[ofs:ofs + 80] + b"\n")


def test_queue_bound_does_not_change_results(tmp_path, monkeypatch):
    """Tiny queue (forces many producer/consumer handoffs) == huge queue,
    exact hash arrays and sequence order."""
    fa = tmp_path / "multi.fna"
    _write_fasta(fa, n_seqs=40, seq_len=12000)
    from rabbittclust_tpu.sketch.kssd import sketch_sequences_kssd

    monkeypatch.setenv("RTC_SEQ_QUEUE_BYTES", "20000")  # < 2 records
    ss_small, _ = sketch_sequences_kssd(str(fa), min_len=1000,
                                        kmer_size=21, drlevel=3, threads=2)
    monkeypatch.setenv("RTC_SEQ_QUEUE_BYTES", str(1 << 30))
    ss_big, _ = sketch_sequences_kssd(str(fa), min_len=1000,
                                      kmer_size=21, drlevel=3, threads=2)
    assert ss_small.names == ss_big.names == [f"seq{i}" for i in range(40)]
    for a, b in zip(ss_small.hashes, ss_big.hashes):
        assert np.array_equal(a, b)


_RSS_CHILD = r"""
import os, sys
import numpy as np
from rabbittclust_tpu.sketch.kssd import sketch_sequences_kssd

def vmhwm_mb():
    # NOT getrusage(ru_maxrss): Linux folds the pre-exec (forked) mm's
    # hiwater into the task's maxrss, so a child of a fat parent (pytest
    # with jax loaded) inherits the PARENT's peak.  VmHWM is per-mm and
    # resets at execve — it measures only this process's own usage.
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) // 1024
    return -1

base_mb = vmhwm_mb()
ss, p = sketch_sequences_kssd(sys.argv[1], min_len=1000, kmer_size=21,
                              drlevel=3, threads=2)
peak_mb = vmhwm_mb()
total = sum(len(h) for h in ss.hashes)
print(f"RSS {peak_mb} {len(ss)} {total} base {base_mb}", flush=True)
"""


@pytest.mark.slow
def test_multi_hundred_mb_file_streams_bounded(tmp_path):
    """A ~300 MB by-sequence FASTA must sketch within a bounded RSS: with
    the old slurp the child needs baseline + ~300 MB of records; streaming
    with a 32 MB queue stays far below that."""
    fa = tmp_path / "big.fna"
    n_seqs, seq_len = 3000, 100_000  # ~304 MB with newlines
    _write_fasta(fa, n_seqs=n_seqs, seq_len=seq_len)
    size_mb = os.path.getsize(fa) // (1 << 20)
    assert size_mb >= 280

    env = dict(os.environ)
    env["RTC_SEQ_QUEUE_BYTES"] = str(32 << 20)
    env["JAX_PLATFORMS"] = "cpu"
    # host-only child: the conftest's 8-virtual-device XLA flag would
    # inflate the import baseline and pollute the RSS bound
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _RSS_CHILD, str(fa)], capture_output=True,
        text=True, env=env, cwd=repo, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RSS ")][-1]
    _, peak_mb, n, total, _, base_mb = line.split()
    assert int(n) == n_seqs
    assert int(total) > 0
    # import baseline (jax et al.) is ~170 MB; the 300 MB of sequence data
    # must NOT be resident on top of it
    assert int(peak_mb) < 330, (
        f"peak RSS {peak_mb} MB (import baseline {base_mb} MB, "
        f"stderr: {proc.stderr[-200:]}) — ingest slurped?")


def test_midline_gt_at_buffer_boundary(tmp_path):
    """A '>' byte inside a sequence line must parse the same regardless of
    where the native reader's 1 MB refill boundary lands (advisor round-4:
    the memchr bulk-consume path used to start a new record when the
    continuation byte after a refill was '>')."""
    from rabbittclust_tpu.sketch.kssd import sketch_sequences_kssd

    rng = np.random.default_rng(5)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bytearray(lut[rng.integers(0, 4, size=(1 << 20) + 5000)].tobytes())
    hdr_a = b">s0 x\n"
    # '>' lands exactly at file offset 1<<20 = the first refill boundary
    seq[(1 << 20) - len(hdr_a)] = ord(">")
    fa = tmp_path / "boundary.fna"
    fa.write_bytes(hdr_a + bytes(seq) + b"\n")
    # identical record, header padded so the same '>' byte sits mid-buffer
    fb = tmp_path / "shifted.fna"
    fb.write_bytes(b">s0 x" + b"P" * 64 + b"\n" + bytes(seq) + b"\n")

    ss_a, _ = sketch_sequences_kssd(str(fa), min_len=1000, kmer_size=21,
                                    drlevel=3, threads=1)
    ss_b, _ = sketch_sequences_kssd(str(fb), min_len=1000, kmer_size=21,
                                    drlevel=3, threads=1)
    assert ss_a.names == ss_b.names == ["s0"]
    assert np.array_equal(ss_a.hashes[0], ss_b.hashes[0])
