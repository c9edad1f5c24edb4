"""Nothing of the benchmark imports JAX or the JAX package, and the
plain reference and the yardstick import nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "svtav1_tpu"}


def _imports(path: Path):
    """Top-level names of every module path.py imports, with the package
    a relative import resolves to."""
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(BENCH.parent).with_suffix("").parts[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                yield ".".join(base + ((node.module,) if node.module else ()))
            else:
                yield node.module


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_whole_name_compare():
    # the port's name begins with the JAX package's: only the whole
    # top-level name counts
    assert "svtav1_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "svtav1_tpu.ops".split(".")[0] in FORBIDDEN


def test_reference_and_yardstick_stand_alone():
    for sub in ("reference", "yardstick"):
        for f in sorted((BENCH / sub).glob("*.py")):
            for m in _imports(f):
                top = m.split(".")[0]
                assert top != "svtav1_tpu_torch", (f, m)
                assert not m.startswith("benchmark.pipelines"), (f, m)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.reference import encoder, coder, tables; "
            "from benchmark.yardstick import clips, stats, workcount; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & (FORBIDDEN | {"svtav1_tpu_torch"})
