"""Runtime configuration: the --device platform check, the compile-cache
placement, the bench's peak table, the native build and the profiler."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platforms,accepted", [
    ("cpu", True), (None, False), ("cuda,cpu", False)])
def test_device_platform_check(monkeypatch, platforms, accepted):
    """On the CPU backend --device runs only when JAX_PLATFORMS=cpu asked
    for it."""
    from rabbittclust_tpu.utils.jaxcfg import check_device_platform
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    if accepted:
        check_device_platform()
    else:
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            check_device_platform()


def test_cli_device_refused_without_gpu(monkeypatch, tmp_path, capsys):
    from rabbittclust_tpu.cli.clust_mst import main
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    out = tmp_path / "out.cluster"
    with pytest.raises(SystemExit) as exc:
        main(["--fast", "-l", "-i", str(tmp_path / "none.list"), "-o",
              str(out), "--device", "-e"])
    assert exc.value.code != 0
    assert "NVIDIA GPU" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    import jax
    from rabbittclust_tpu.utils import jaxcfg
    updates = {}
    monkeypatch.setattr(jaxcfg, "_configured", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv(jaxcfg.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(jaxcfg.CACHE_ENV, str(tmp_path / env_dir))
    jaxcfg.configure_jax()
    if env_dir is None:
        fixed = os.path.join(REPO, ".cache", "jax_cache")
        assert updates["jax_compilation_cache_dir"] == fixed
        assert os.path.isdir(fixed)
    else:
        # JAX reads the variable itself; nothing may override it
        assert "jax_compilation_cache_dir" not in updates


@pytest.mark.parametrize("kind,bf16", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", None),
    ("cpu", None),
])
def test_bench_peak_table(kind, bf16):
    import bench
    if bf16 is None:
        with pytest.raises(KeyError):
            bench.device_peaks(kind)
    else:
        peaks = bench.device_peaks(kind)
        assert peaks["bf16_flops_per_s"] == bf16
        assert peaks["int8_ops_per_s"] == 1979e12
        assert peaks["hbm_bytes_per_s"] == 3.35e12


def test_native_build_key():
    from rabbittclust_tpu.utils import native
    k = native.build_key(b"int f();")
    assert k == native.build_key(b"int f();")
    assert k != native.build_key(b"int g();")
    assert k != native.build_key(b"int f();", flags=("-O2",))
    with open(os.path.join(REPO, "native", "rtc_native.cpp"), "rb") as f:
        key = native.build_key(f.read())
    assert native.library_path() == os.path.join(
        REPO, "native", "build", f"librtc_native-{key}.so")
    assert "-march=native" not in native.BUILD_FLAGS


@pytest.mark.parametrize("compiles", [True, False])
def test_native_atomic_install(monkeypatch, tmp_path, compiles):
    """The compiler writes a temporary file beside the target, which is
    renamed into place only after a successful build; a failed build
    leaves nothing behind."""
    from rabbittclust_tpu.utils import native
    target = str(tmp_path / "librtc_native-key.so")

    def fake_compiler(cmd, **_):
        out = cmd[cmd.index("-o") + 1]
        assert os.path.dirname(out) == str(tmp_path) and out != target
        with open(out, "wb") as f:
            f.write(b"partial" if not compiles else b"library")
        if not compiles:
            raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(native.subprocess, "run", fake_compiler)
    if compiles:
        native.build_native(target)
        with open(target, "rb") as f:
            assert f.read() == b"library"
        assert os.listdir(tmp_path) == [os.path.basename(target)]
    else:
        with pytest.raises(subprocess.CalledProcessError):
            native.build_native(target)
        assert os.listdir(tmp_path) == []


def test_profiler_raises_when_trace_cannot_start(monkeypatch, tmp_path):
    from rabbittclust_tpu.utils.profiling import maybe_trace
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    monkeypatch.setenv("RTC_PROFILE_DIR", str(blocker))
    ran = []
    with pytest.raises(OSError):
        with maybe_trace("phase"):
            ran.append(1)
    assert ran == []


def test_profiler_body_error_propagates(monkeypatch, tmp_path):
    from rabbittclust_tpu.utils.profiling import maybe_trace
    monkeypatch.setenv("RTC_PROFILE_DIR", str(tmp_path))
    ran = []
    with pytest.raises(ValueError):
        with maybe_trace("phase"):
            ran.append(1)
            raise ValueError("body")
    assert ran == [1]
