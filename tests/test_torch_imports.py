"""The port stands alone: no JAX, nothing of pilosa_tpu, no silent CPU.

Walks every module of pilosa_tpu_torch/ and chip_smoke.py with `ast`.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "pilosa_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(tree: ast.AST) -> list[str]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def _mentions(node: ast.AST, text: str) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == text
               or isinstance(n, ast.Name) and n.id == text
               for n in ast.walk(node))


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for mod in _imported_modules(tree):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}: imports {mod}"
        assert top != "pilosa_tpu", f"{path}: imports {mod}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_cuda_never_quietly_becomes_cpu(path):
    """No `device` parameter defaults to the CPU, and no branch on
    torch.cuda.is_available() picks "cpu"."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args.args + node.args.kwonlyargs
            defaults = ([None] * (len(node.args.args) - len(node.args.defaults))
                        + list(node.args.defaults) + list(node.args.kw_defaults))
            for arg, default in zip(args, defaults):
                if arg.arg == "device" and default is not None:
                    assert not _is_cpu(default), \
                        f"{path}:{node.lineno}: device defaults to cpu"
        if isinstance(node, ast.IfExp) and _mentions(node.test, "is_available"):
            assert not (_is_cpu(node.body) or _is_cpu(node.orelse)), \
                f"{path}:{node.lineno}: is_available() falls back to cpu"


def test_the_walk_covers_the_port():
    names = {p.name for p in FILES}
    assert {"kernels.py", "executor.py", "server.py", "chip_smoke.py"} <= names
    assert (ROOT / "pilosa_tpu_torch" / "csrc" / "bitmap_kernels.cu").exists()
