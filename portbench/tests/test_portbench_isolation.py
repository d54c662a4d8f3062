"""Nothing the benchmark runs imports JAX, flax or the JAX package, and the
reference imports nothing of the program (top-level names compared whole)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_level_imports(path))


def test_the_check_compares_whole_names(tmp_path):
    tmp = tmp_path / "names.py"
    tmp.write_text("import repro_torch.serve\nfrom repro_torchx import y\nimport jax.numpy\n")
    assert set(top_level_imports(tmp)) == {"repro_torch", "repro_torchx", "jax"}
    assert set(top_level_imports(tmp)) & FORBIDDEN == {"jax"}
