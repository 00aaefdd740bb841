"""No module under perfbench/ imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``), and the
plain reference imports nothing of the port."""

import ast
import pathlib

import pytest

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PERFBENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(PERFBENCH).as_posix()
                              for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_port():
    for path in (PERFBENCH / "reference").glob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path
        assert "perfbench" not in top_level_imports(path), path


def test_the_scan_sees_through_the_prefix():
    # repro_torch shares the JAX package's prefix; the names are whole
    assert top_level_imports(PERFBENCH / "programs" / "resnet8.py") \
        >= {"repro_torch"}
    assert "repro" not in top_level_imports(
        PERFBENCH / "programs" / "resnet8.py")
