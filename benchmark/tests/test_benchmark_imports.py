"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program; top-level names compared
whole (the port's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REFUSED = {"jax", "jaxlib", "flax", "zutis_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & REFUSED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "zutis_tpu_torch" not in set(top_level_imports(path))


def test_names_are_compared_whole():
    from benchmark import harness
    import sys
    assert "zutis_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    sys.modules.setdefault("zutis_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    del sys.modules["zutis_tpu_torch_probe"]
