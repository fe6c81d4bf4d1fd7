"""No run loads JAX or the JAX package (top-level module names compared
whole: ``lpopc_tpu_torch`` begins with ``lpopc_tpu`` and is not it), the
benchmark imports none of the repository's older measuring scripts, and the
plain reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import REPO

HOME = os.path.join(REPO, "ocpbench")


def imported_tops(path):
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_banned_names_are_compared_whole():
    code = (
        "import sys, types; sys.path.insert(0, %r)\n"
        "from ocpbench import run\n"
        "sys.modules['lpopc_tpu_torch_extra'] = types.ModuleType('x')\n"
        "assert run.banned_modules() == [], run.banned_modules()\n"
        "sys.modules['lpopc_tpu.core'] = types.ModuleType('y')\n"
        "sys.modules['jaxlib'] = types.ModuleType('z')\n"
        "assert run.banned_modules() == ['jaxlib', 'lpopc_tpu'], run.banned_modules()\n"
    ) % REPO
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_a_run_loads_no_jax():
    """Everything a run imports, the program included, then the check."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from ocpbench import run, spec, judge, profiling, program, traffic, roofline, control\n"
        "import lpopc_tpu_torch.parallel.batch, lpopc_tpu_torch.core.solve\n"
        "import lpopc_tpu_torch.models.brysondenham, lpopc_tpu_torch.models.hypersensitive\n"
        "import json\n"
        "for w in json.load(open(%r))['workloads']:\n"
        "    cell = spec.resolve(w['name'], %r)\n"
        "    for m in cell.end_to_end + cell.per_layer:\n"
        "        spec.reader(%r, m['name'])\n"
        "assert run.banned_modules() == [], run.banned_modules()\n"
    ) % (REPO, os.path.join(REPO, "BENCHMARK.json"), REPO, REPO)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": ""})


def test_sources_import_no_jax_and_no_old_scripts():
    banned = {"jax", "jaxlib", "flax", "lpopc_tpu", "bench", "chip_smoke", "scripts",
              "__graft_entry__"}
    for path in glob.glob(os.path.join(HOME, "**", "*.py"), recursive=True):
        assert not imported_tops(path) & banned, path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HOME, "reference", "*.py")):
        assert imported_tops(path) <= {"__future__", "math", "numpy", "torch", "ocpbench"}, path
        assert "lpopc" not in "".join(
            ast.unparse(n) for n in ast.walk(ast.parse(open(path).read()))
            if isinstance(n, (ast.Import, ast.ImportFrom))), path
