"""Isolation: nothing under benchmark/ imports JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), the reference imports nothing of the port, a run succeeds
where neither can be imported, and a run that finds either loaded in its
process prints no result."""

import ast
import os
import subprocess
import sys
import textwrap

import run as run_py
from harness import bench

BANNED = {"jax", "jaxlib", "flax", "arec"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for root, dirs, files in os.walk(bench.HERE):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        yield from (os.path.join(root, f) for f in files
                    if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources() for m in _imports(p)
             if m in BANNED}
    assert not found
    assert "arec_torch" not in BANNED and "arec_torch".startswith("arec")


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(bench.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            mods = set(_imports(os.path.join(ref, f)))
            assert mods - sys.stdlib_module_names <= {"numpy", "torch",
                                                      "reference"}, f


def test_a_run_needs_neither_jax_nor_the_jax_package(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {sorted(BANNED)!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path[:0] = [{bench.HERE!r}]
        import conftest, run
        from harness import bench
        find = bench.Cell.find
        bench.Cell.find = staticmethod(
            lambda n, s=None: conftest.tiny(find(n, s)))
        bench.CACHE = {str(tmp_path)!r}
        sys.exit(run.main(["--workload", "c4-serve-online", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], device="cpu"))
    """)
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "\"correct\": true" in p.stdout.strip().splitlines()[-1], p.stderr[-2000:]


def test_a_run_with_jax_loaded_prints_no_result(tiny_cells, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["os"])
    rc = run_py.main(["--workload", "xing-mf-serve-batch", "--seed", "4",
                      "--seconds", "1", "--trace", "0"], device="cpu")
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "jax" in out.err


def test_a_run_without_the_program_fails_before_any_result(tmp_path):
    import shutil
    shutil.copytree(bench.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(bench.REPO, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "xing-mf-train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
