"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole:
``whisper_apr_tpu_torch`` begins with ``whisper_apr_tpu``)."""

import ast

import pytest

from perfbench import spec

FILES = sorted((spec.REPO / "perfbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "whisper_apr_tpu"}


def imported(path):
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.REPO)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (spec.REPO / "perfbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    names = imported(path)
    assert "whisper_apr_tpu_torch" not in names
    assert not names & FORBIDDEN
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch"}


def test_top_level_names_compared_whole():
    assert "whisper_apr_tpu_torch".split(".")[0] not in FORBIDDEN
