"""PyTorch port, the kernel build: the library name follows every source
file that goes into it, so an edited header is never served from a stale
library, and an installed package ships every one of those files."""

import fnmatch
import pathlib
import tomllib

import pytest

from basic_pitch_torch import _build

REPO = pathlib.Path(__file__).resolve().parent.parent


def _tree(tmp_path, header_body):
    csrc = tmp_path / "csrc"
    (csrc / "sub").mkdir(parents=True)
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint main() { return A; }\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "sub/b.cuh"\n#define A 1\n')
    (csrc / "sub" / "b.cuh").write_text(header_body)
    return csrc


def test_sources_follow_local_includes(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, "#define B 2\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    names = sorted(p.relative_to(csrc).as_posix() for p in _build.sources("k"))
    assert names == ["a.cuh", "k.cu", "sub/b.cuh"]


def test_library_hash_changes_with_an_included_header(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, "#define B 2\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (csrc / "sub" / "b.cuh").write_text("#define B 3\n")
    assert _build.library_path("k") != before


def test_greedy_decode_sources_include_its_header():
    names = {p.name for p in _build.sources("greedy_decode")}
    assert names == {"greedy_decode.cu", "warp_walk.cuh"}


def test_package_data_ships_every_kernel_source():
    """An installed package builds its kernel from the package data alone,
    so every file the build reads must match one of its globs."""
    config = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = config["tool"]["setuptools"]["package-data"]["basic_pitch_torch"]
    for path in _build.sources("greedy_decode"):
        rel = path.relative_to(_build.PACKAGE_DIR).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
    assert any(fnmatch.fnmatch("assets/nmp_icassp2022.npz", g) for g in globs)


def test_package_find_ships_every_subpackage():
    """The package find of pyproject.toml picks up every subpackage of the
    port (the training slice's `train` and `data` among them)."""
    from setuptools import find_packages

    config = tomllib.loads((REPO / "pyproject.toml").read_text())
    found = set(find_packages(str(REPO), include=config["tool"]["setuptools"]["packages"]["find"]["include"]))
    on_disk = {
        "basic_pitch_torch" + ("." + ".".join(p.parent.relative_to(_build.PACKAGE_DIR).parts) if p.parent != _build.PACKAGE_DIR else "")
        for p in _build.PACKAGE_DIR.rglob("__init__.py")
    }
    assert {"basic_pitch_torch.train", "basic_pitch_torch.data"} <= on_disk <= found


NATIVE = ("greedy_decode", "pcm_decode", "pcm_pack")


@pytest.mark.parametrize("name", NATIVE)
def test_package_data_ships_every_native_source(name):
    config = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = config["tool"]["setuptools"]["package-data"]["basic_pitch_torch"]
    for path in _build.sources(name):
        rel = path.relative_to(_build.PACKAGE_DIR).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)


def test_codec_sources_and_compilers(tmp_path, monkeypatch):
    """pcm_decode is a CUDA source built with nvcc, pcm_pack a host source
    built with g++ and the JAX package's flags; a .cu wins over a .cpp of the
    same name, and the flags are part of the library's name."""
    assert [p.name for p in _build.sources("pcm_decode")] == ["pcm_decode.cu"]
    assert [p.name for p in _build.sources("pcm_pack")] == ["pcm_pack.cpp"]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cpp").write_text("int f() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    host = _build.library_path("k")
    monkeypatch.setattr(_build, "HOST_FLAGS", ("-O2", "-shared", "-fPIC"))
    assert _build.library_path("k") != host
    (csrc / "k.cu").write_text("int f() { return 1; }\n")
    assert _build.source("k").name == "k.cu"


def test_host_build_compiles_and_loads(tmp_path, monkeypatch):
    """The g++ path end to end on a tiny source."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "tiny.cpp").write_text('extern "C" int tiny(int x) { return 3 * x; }\n')
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    lib = _build.load("tiny")
    assert lib.tiny(14) == 42
    assert _build.library_path("tiny").exists()


def test_host_build_reports_a_missing_compiler(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "tiny.cpp").write_text("int f() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build("tiny")
