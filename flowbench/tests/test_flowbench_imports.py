"""Nothing under flowbench/ imports jax or the JAX package, and the
reference imports nothing of the port: each import's top-level name is
compared whole (``eppm_tpu_torch`` is not ``eppm_tpu``)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FILES = sorted(HERE.rglob("*.py"))


def top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_names(path)) & {"jax", "jaxlib", "flax", "eppm_tpu"}


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_independent_of_port(path):
    names = set(top_names(path))
    assert not names & {"eppm_tpu_torch", "flowbench"}, names
    assert names <= {"torch", "numpy", "math", "functools", "dataclasses",
                     "typing", "__future__", "hashlib"}, names


def test_top_names_sees_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom eppm_tpu.ops import x\n"
                 "import eppm_tpu_torch\n")
    assert set(top_names(f)) == {"jax", "eppm_tpu", "eppm_tpu_torch"}
