"""The port imports nothing of JAX or of the JAX package.

An AST scan of every .py file under cspn_tpu_torch/ and of chip_smoke.py
(`'jax' in sys.modules` says nothing here: this host imports jax at
interpreter start-up)."""

import ast
import pathlib

import pytest

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cspn_tpu")
_FILES = sorted((_ROOT / "cspn_tpu_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


@pytest.mark.parametrize("path", _FILES, ids=lambda p: str(p.relative_to(_ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported(ast.parse(path.read_text(), str(path))) if _forbidden(m)]
    assert not bad, f"{path.relative_to(_ROOT)} imports {bad}"


def test_scan_catches_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom cspn_tpu.ops import cspn\nimport cspn_tpu_torch\nfrom flax import linen\n"
    found = [m for m in _imported(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "cspn_tpu.ops", "flax"]
    assert len(_FILES) > 20
