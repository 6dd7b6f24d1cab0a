"""What the benchmark's runs load: nothing of JAX or the JAX package (the
port's name starts with the JAX package's, so names are compared whole, by
their top-level part), and a reference that loads nothing of the port."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from liobench.tests.tiny import CELLS

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "fast_lio_tpu"}


def _in_fresh_process(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads_no_jax(workload):
    """Each cell's driver at a tiny size with the plain versions, in a
    process of its own: afterwards no module's top-level name is JAX's,
    jaxlib's, flax's or the JAX package's."""
    got = _in_fresh_process(f"""
import json, sys
from liobench.tests.tiny import run
out = run({workload!r})
tops = sorted({{m.split('.', 1)[0] for m in sys.modules}})
print(json.dumps({{"tops": tops, "correct": out["correct"],
                  "attempted": out["attempted"]}}))
""")
    assert got["attempted"] > 0
    assert "fast_lio_tpu_torch" in got["tops"]
    assert not FORBIDDEN & set(got["tops"]), FORBIDDEN & set(got["tops"])


def test_forbidden_names_compared_whole():
    from liobench import harness
    assert "fast_lio_tpu_torch" not in harness.FORBIDDEN
    assert set(harness.FORBIDDEN) == FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    """``liobench/reference/`` imports neither the port nor JAX: by its
    source, and in a fresh process that imports it."""
    for path in (ROOT / "liobench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                assert node.level == 0 or not node.module or \
                    node.module.split(".")[0] in ("lio", "sync"), path
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "fast_lio_tpu_torch", "liobench"}, (path, n)
    got = _in_fresh_process("""
import json, sys
import liobench.reference.lio, liobench.reference.sync
print(json.dumps({"tops": sorted({m.split('.', 1)[0] for m in sys.modules})}))
""")
    assert not (FORBIDDEN | {"fast_lio_tpu_torch"}) & set(got["tops"])
