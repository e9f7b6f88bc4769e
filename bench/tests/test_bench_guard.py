"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared as whole words: ``repro_torch`` begins with ``repro`` and is
not ``repro``."""
import ast
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def top_names(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def run_py(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_nor_the_jax_package():
    """A whole run (at a CPU test's size) through the harness that
    ``bench/run.py`` drives, then every loaded module's top-level name."""
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r},
                {str(BENCH / 'tests')!r}]
from conftest import tiny
import run
from harness import core
for w in ("vampire-ddr3l.surface-long", "vampire-fleet10k.map-spec"):
    out = core.run_cell(w, 5, 0.1, False, t_start_ns=time.perf_counter_ns(),
                        device="cpu", overrides=tiny(w))
    assert out["result"]["correct"], out
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    names = set(eval(run_py(code)))
    assert "repro_torch" in names
    assert not names & BANNED, names & BANNED


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
import reference.vampire, reference.params
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    names = set(eval(run_py(code)))
    assert not names & (BANNED | {"repro_torch", "harness"}), names


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        names = top_names(path)
        assert not names & BANNED, (path, names & BANNED)
        if path.parent.name == "reference":
            assert "repro_torch" not in names, path
            assert "harness" not in names, path


def test_the_run_refuses_a_process_that_holds_jax():
    code = f"""
import sys, types
sys.path[:0] = [{str(BENCH)!r}]
from harness import core
clean = core.banned_modules()
sys.modules["repro_torch_extra"] = types.ModuleType("repro_torch_extra")
sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
print([clean, core.banned_modules()])
"""
    clean, dirty = eval(run_py(code))
    assert clean == [] and dirty == ["jax"]
