"""Nothing the harness or the reference imports is JAX or the JAX
package, compared by whole top-level names; the reference imports nothing
of the program."""
import ast
import subprocess
import sys

from bench.harness.spec import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_top_level_names_are_compared_whole():
    from bench.harness.runner import forbidden_modules
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torchx"] = sys.modules["sys"]
        assert forbidden_modules() == sorted(
            {m.split(".")[0] for m in mods} & FORBIDDEN)
    finally:
        sys.modules.pop("repro_torchx", None)


def test_no_source_under_paths_imports_the_jax_side():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "repro_torch" not in tops, path


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench.harness.runner, bench.reference.judge\n"
        "import repro_torch.core\n"
        "bad = {m.split('.')[0] for m in sys.modules} & %r\n"
        "assert not bad, bad\n"
        "import bench.reference.algorithm as a\n" % (
            str(ROOT), str(ROOT / "src"), FORBIDDEN))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_the_reference_alone_loads_no_program_module():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "import bench.reference.judge, bench.reference.algorithm\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('repro_torch', 'repro', 'jax')]\n"
        % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
