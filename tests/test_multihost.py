"""Multi-host (jax.distributed) layer: 2-process CPU-mesh simulation.

Each child process owns a contiguous genome block, contributes its rows to
the globally sharded signature array, runs the bitmap ring over the
global mesh, exact-verifies its own candidates, and allgathers the edge
forests — the partition must equal the single-host engine on every
process (see rabbittclust_tpu/parallel/multihost._sim_child for the
asserts, which include byte-equal MST cuts)."""

import numpy as np
import pytest


@pytest.mark.slow
def test_two_process_four_device_sim():
    from rabbittclust_tpu.parallel.multihost import launch_local_sim

    outs = launch_local_sim(num_processes=2, devices_per_proc=4,
                            n_genomes=48)
    assert len(outs) == 2
    digests = set()
    for o in outs:
        assert o.startswith("OK proc="), o
        assert "devices=8" in o
        digests.add(o.split("digest=")[1])
    assert len(digests) == 1  # identical clusters on every host


@pytest.mark.slow
def test_three_process_uneven_split_sim():
    """Uneven genome split (50 over 3 processes) with per-process padding:
    pads must never alias real rows."""
    from rabbittclust_tpu.parallel.multihost import launch_local_sim

    outs = launch_local_sim(num_processes=3, devices_per_proc=2,
                            n_genomes=50)
    digests = {o.split("digest=")[1] for o in outs}
    assert len(digests) == 1
    assert all("devices=6" in o for o in outs)


def test_shard_bounds_cover_everything():
    from rabbittclust_tpu.parallel.multihost import shard_bounds

    for n in (1, 7, 48, 50, 101):
        for np_ in (1, 2, 3, 5, 8):
            spans = [shard_bounds(n, np_, p) for p in range(np_)]
            ids = [g for lo, hi in spans for g in range(lo, hi)]
            assert ids == list(range(n)), (n, np_)


def test_allgather_ragged_is_byte_exact_single_proc():
    """float64 / uint64 payloads survive the jax allgather bit-exactly
    (single-process degenerate case still exercises the byte-view path)."""
    from rabbittclust_tpu.parallel.multihost import _allgather_ragged

    d = np.array([0.014936074231192451, 1e-300, -1.5], dtype=np.float64)
    (got,) = _allgather_ragged(d)
    assert got.tolist() == d.tolist() and got.dtype == np.float64
    u = np.array([2 ** 63 + 12345, 7], dtype=np.uint64)
    (gu,) = _allgather_ragged(u)
    assert gu.tolist() == u.tolist() and gu.dtype == np.uint64
