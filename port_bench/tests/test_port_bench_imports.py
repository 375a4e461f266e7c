"""Nothing under port_bench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their whole top-level name (the part before the first dot): the port's
name begins with the JAX package's."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "basic_pitch_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "basic_pitch_torch" not in top_level_imports(path)


def test_the_check_compares_whole_top_level_names():
    from pb import bench

    assert "basic_pitch_torch" not in bench.FORBIDDEN_MODULES
    assert set(bench.FORBIDDEN_MODULES) == FORBIDDEN
