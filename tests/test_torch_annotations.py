"""PyTorch port: the typing gate of `tools/check_annotations.py`, over all of
`basic_pitch_torch/` and with no grandfathered misses.

The rule is the tool's: every public module-level function and every public
method of a module-level class annotates all its parameters (``self`` and
``cls`` aside) and its return. The scan here is its own AST walk, held equal
to the tool's `misses_in` so the two rules cannot drift apart; the tool
itself scans only the JAX package.
"""

import ast
import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "basic_pitch_torch"
MODULES = sorted(p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py"))


def _tool():
    spec = importlib.util.spec_from_file_location("check_annotations", REPO / "tools" / "check_annotations.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def misses(source: str) -> list:
    """Public functions of ``source`` that miss an annotation, as
    "name:line (what)"."""
    out = []
    tree = ast.parse(source)
    nodes = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nodes.append(node)
        elif isinstance(node, ast.ClassDef):
            nodes += [n for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for node in nodes:
        if node.name.startswith("_"):
            continue
        a = node.args
        missing = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs if p.annotation is None and p.arg not in ("self", "cls")]
        if a.vararg is not None and a.vararg.annotation is None:
            missing.append("*" + a.vararg.arg)
        if a.kwarg is not None and a.kwarg.annotation is None:
            missing.append("**" + a.kwarg.arg)
        if missing or node.returns is None:
            out.append(f"{node.name}:{node.lineno} ({','.join(missing) or '<return>'})")
    return out


@pytest.mark.parametrize("module", MODULES)
def test_module_is_fully_annotated(module):
    path = PORT / module
    found = misses(path.read_text())
    assert found == _tool().misses_in(path)
    assert not found, f"{module}: {found}"


def test_scan_covers_the_format_modules():
    for name in ("savedmodel", "tflite_import", "onnx_import", "coreml_import", "onnx_export", "onnx_eval", "tf_export"):
        assert f"models/{name}.py" in MODULES
    assert "cli/export.py" in MODULES and "__init__.py" in MODULES


def test_rule_catches_each_kind_of_miss(tmp_path):
    """The scan sees a missing parameter, a missing return, *args and
    **kwargs, in functions and methods; it ignores private names, self, and
    closures."""
    source = (
        "def ok(x: int) -> int:\n    def inner(y):\n        return y\n    return x\n"
        "def no_return(x: int):\n    return x\n"
        "def no_param(x) -> None:\n    pass\n"
        "def star(*a, **k) -> None:\n    pass\n"
        "def _private(x):\n    pass\n"
        "class C:\n"
        "    def __init__(self, x):\n        pass\n"
        "    def method(self, y) -> None:\n        pass\n"
        "    @classmethod\n    def make(cls) -> 'C':\n        return cls(1)\n"
    )
    want = ["no_return:5 (<return>)", "no_param:7 (x)", "star:9 (*a,**k)", "method:16 (y)"]
    assert misses(source) == want
    path = tmp_path / "m.py"
    path.write_text(source)
    assert _tool().misses_in(path) == want
