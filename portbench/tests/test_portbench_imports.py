"""What the harness loads: never JAX or the JAX package (top-level names
compared whole), and a reference that loads nothing of the measured
package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

PORTBENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("names,found", [
    (["cilantro_tpu_torch", "cilantro_tpu_torch.slam", "numpy"], []),
    (["cilantro_tpu", "cilantro_tpu.core"], ["cilantro_tpu", "cilantro_tpu.core"]),
    (["jax", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib.xla_client"]),
    (["jaxtyping", "flaxen", "cilantro_tpu_tools"], []),
])
def test_forbidden_compares_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


def _imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORTBENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imported_names(path)}
    assert not tops & {"jax", "jaxlib", "flax", "cilantro_tpu"}


def test_reference_loads_nothing_of_the_measured_package():
    code = ("import sys; import portbench.reference.pool, portbench.reference.splat, "
            "portbench.compare, portbench.clips; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cilantro_tpu_torch', 'cilantro_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORTBENCH.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
