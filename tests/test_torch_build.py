"""The port's kernel build helper (``ops/_build.py``) on the CPU: library
names are keyed by the source, the shared headers and the flags, so a
changed header rebuilds every kernel; a built library is not rebuilt; a
failing ``nvcc`` raises with its output."""

import sys

import pytest

from esmdiff_tpu_torch.ops import _build

KERNELS = ("flash_attention", "small_attention", "fused_qkv", "fused_ffn")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a", "b"):
        (src / f"{name}.cu").write_text(f"// kernel {name}\n")
    (src / "common.cuh").write_text("// shared\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "logs", {})
    return src


def test_every_kernel_source_is_in_the_repo():
    for name in KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build._library(name).name.startswith(f"lib{name}_")


def test_library_names_follow_the_sources(csrc):
    a, b = _build._library("a"), _build._library("b")
    assert a != b and a.parent == _build.BUILD_DIR
    assert _build._library("a") == a                  # stable
    (csrc / "common.cuh").write_text("// shared, changed\n")
    assert _build._library("a") != a and _build._library("b") != b
    a2 = _build._library("a")
    (csrc / "a.cu").write_text("// kernel a, changed\n")
    assert _build._library("a") != a2


def test_built_library_is_not_rebuilt(csrc, monkeypatch):
    so = _build._library("a")
    so.parent.mkdir(parents=True)
    so.write_bytes(b"")
    so.with_suffix(".log").write_text("ptxas info: 42 registers")

    def no_nvcc(*a, **kw):
        raise AssertionError("nvcc must not run for a built library")

    monkeypatch.setattr(_build.subprocess, "Popen", no_nvcc)
    _build.build("a")
    assert _build.logs["a"] == "ptxas info: 42 registers"


def test_nvcc_failure_raises_with_its_output(csrc, monkeypatch):
    fake = csrc.parent / "nvcc"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\nprint('error: bad kernel')\nsys.exit(2)\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda _: str(fake))
    with pytest.raises(RuntimeError, match="a.cu: nvcc exit code 2"):
        _build.build("a", "b")
    assert "error: bad kernel" in _build.logs["a"]
    assert not _build._library("a").exists()
