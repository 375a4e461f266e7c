"""PyTorch port, the kernel build: the library name follows every source
file that goes into it, so an edited header is never served from a stale
library, and an installed package ships every one of those files."""

import fnmatch
import pathlib
import tomllib

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
