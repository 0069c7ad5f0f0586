"""Nothing under snapbench/ imports JAX or the JAX package (top-level names
compared whole: repro_torch begins with repro), the plain reference
imports nothing of the program, and nothing reads the JAX package's
benchmarks/ folder."""

import ast
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(HOME.rglob("*.py"))


def test_no_jax_nor_the_jax_package():
    for path in sources():
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_takes_nothing_of_the_program():
    for path in (HOME / "reference").glob("*.py"):
        assert "repro_torch" not in imported(path), path
        assert "repro_torch" not in path.read_text(), path
    for path in (HOME / "datagen.py", HOME / "generator.py"):
        assert "repro_torch" not in imported(path)


def test_whole_names_are_compared():
    import repro_torch  # noqa: F401  (its name begins with "repro")
    from snapbench.harness import FORBIDDEN as RUN_FORBIDDEN, loaded_forbidden
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert loaded_forbidden() == []


def test_nothing_reads_benchmarks():
    for path in sources():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path
