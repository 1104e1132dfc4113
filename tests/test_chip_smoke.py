"""chip_smoke.py: every phase at a tiny size on the CPU, the same phases at
full size on a card (marker `gpu`), and the refusal to report success
anywhere but on a GPU."""

import pytest

import chip_smoke

# small sizes that take each phase through the same entry points; ``s`` is
# the hashes per sketch
TINY = {
    "a": dict(clusters=2, per_cluster=3, length=120_000),
    "b": dict(n=512, s=200),
    "c": dict(n=384, s=200),
    "d": dict(n=256, s=200),
    "e": dict(n=512, s=200, probe=False),
    "f": dict(n=512, bits=8192, s=200),
    "g": dict(bases=200_000),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_tiny_on_cpu(phase, tmp_path, monkeypatch):
    if phase == "e":
        # below 16,384 genomes the density probe always picks the host
        # engine; force the device sweep it would take at full size
        monkeypatch.setenv("RTC_GREEDY_DEVICE", "force")
    info = chip_smoke.PHASES[phase][1](str(tmp_path), 7, **TINY[phase])
    assert info


@pytest.mark.gpu
@pytest.mark.parametrize("phase", sorted(chip_smoke.FULL))
def test_phase_on_card(gpu, phase, tmp_path):
    chip_smoke.PHASES[phase][1](str(tmp_path), 7, **chip_smoke.FULL[phase])


def test_mismatch_is_reported(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_text("the cluster 0 is: \n\t    0\t     1\n")
    b.write_text("the cluster 0 is: \n\t    0\t     2\n")
    assert not chip_smoke.same_bytes(str(a), str(b))
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.check_planted(chip_smoke.read_clusters(str(a)), 4,
                                 n_clusters=1)


def test_main_refuses_cpu(monkeypatch, capsys):
    # main() only defaults CUDA_VISIBLE_DEVICES; keep the test's env intact
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out


def test_planted_sketches_in_kssd_domain():
    from rabbittclust_tpu.sketch.kssd import KssdParams
    hashes = chip_smoke.planted_sketches(130, 3, s=300)
    p = KssdParams.from_kmer_size(chip_smoke.KMER, chip_smoke.DRLEVEL)
    assert not p.use64
    for h in hashes:
        assert h.dtype.itemsize == 4 and len(h) > 250
        assert (h[1:] > h[:-1]).all()  # sorted, no duplicates
        assert int(h.max()) < 1 << p.hash_bits
