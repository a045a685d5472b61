"""No module of the benchmark imports JAX or the JAX package, and no
reference imports the port: each import's top-level name, compared whole
(the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "score_based_channels_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py"))
                         + [ROOT / "channels.py", ROOT / "weights.py"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "score_based_channels_torch" not in names
    assert "perfbench" not in names  # only relative imports


def test_whole_name_rule():
    assert "score_based_channels_torch".split(".")[0] not in JAX
