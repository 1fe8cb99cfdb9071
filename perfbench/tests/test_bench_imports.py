"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package ``repro``: the top-level module name is compared whole, since the
port's name ``repro_torch`` begins with ``repro``.  Nothing reads the
JAX package's benchmarks."""
import ast
import subprocess
import sys

import bench_small

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in (bench_small.ROOT / "perfbench").rglob("*.py")
                 if "tests" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    assert len(SOURCES) > 10
    for path in SOURCES:
        bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        assert not bad, (path, bad)


def test_the_top_level_name_is_compared_whole():
    from perfbench import harness
    assert "repro_torch" not in harness.FORBIDDEN
    assert "repro" in harness.FORBIDDEN


def test_a_run_leaves_no_jax_module_in_the_process():
    code = ("import sys, bench_small; bench_small.run(bench_small.CELLS[0]);"
            "from perfbench import harness;"
            "print(harness.forbidden_modules(),"
            " sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'benchmarks'}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=bench_small.ROOT / "perfbench" / "tests")
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[] []"
