"""Nothing under ``tcqbench/`` imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), nothing
reads ``benchmarks/``, and the reference imports nothing of the program."""

import ast

from tcqbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return [p for p in (ROOT / "tcqbench").rglob("*.py")
            if "__pycache__" not in p.parts]


def test_no_jax_or_jax_package():
    for p in sources():
        assert not imported(p) & FORBIDDEN, p


def test_top_level_names_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "tcqbench" / "reference").rglob("*.py"):
        assert "repro_torch" not in imported(p), p
        assert imported(p) <= {"__future__", "bisect", "typing", "numpy",
                               "torch"}, p


def test_nothing_reads_benchmarks_folder():
    for p in sources():
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert '"benchmarks' not in text and "'benchmarks" not in text, p


def test_run_refuses_loaded_jax():
    from tcqbench import run

    assert run.loaded_forbidden(["repro.core", "numpy"]) == ["repro"]
    assert run.loaded_forbidden(["jaxlib.xla_client", "jax"]) == \
        ["jax", "jaxlib"]
    assert run.loaded_forbidden(["repro_torch.core", "torch"]) == []
