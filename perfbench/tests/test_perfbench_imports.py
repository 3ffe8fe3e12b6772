"""What the benchmark may import: no module under perfbench/ imports JAX
or the JAX package (top-level names compared whole, so the port's
`repro_torch` passes), the plain reference imports nothing of the program,
and nothing imports or opens the JAX-era `benchmarks/` folder."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    names.add(str(arg.value).split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 20
    assert BENCH / "run.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_name_comparison(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\nfrom repro_torch import x\n")
    assert top_level_imports(probe) == {"repro_torch"}
    probe.write_text("import repro.core\n")
    assert top_level_imports(probe) & FORBIDDEN == {"repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def path_constants(path: Path) -> list:
    """String constants of a module other than docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_benchmarks_folder(path):
    assert not [c for c in path_constants(path) if "benchmarks" in c]
