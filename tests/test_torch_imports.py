"""The port stands alone: no module of lpopc_tpu_torch, and not chip_smoke.py,
imports jax or the JAX package; and nothing runs on the CPU unasked."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import lpopc_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the models of the multi-phase slice, and the solve entry of each
MULTIPHASE_MODELS = {
    "launch": "solve", "boostbrake": "solve", "climb": "solve", "reentry": "solve",
    "hangglider": "solve", "goddard": "solve_three_phase", "tumor": "solve_auto",
}


def _port_modules():
    names = ["lpopc_tpu_torch"]
    for mod in pkgutil.walk_packages(lpopc_tpu_torch.__path__, "lpopc_tpu_torch."):
        names.append(mod.name)
    return names


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_port_module_imports_jax_or_the_jax_package():
    mods = _port_modules()
    assert len(mods) >= 20
    assert {"lpopc_tpu_torch.core.block_kkt", "lpopc_tpu_torch.core.kkt_blocks"} <= set(mods)
    assert {"lpopc_tpu_torch.ops.tables"} | {
        f"lpopc_tpu_torch.models.{m}" for m in MULTIPHASE_MODELS} <= set(mods)
    assert {"lpopc_tpu_torch.core.arcs", "lpopc_tpu_torch.core.decompose",
            "lpopc_tpu_torch.core.diff", "lpopc_tpu_torch.parallel.mpc"} <= set(mods)
    assert {"lpopc_tpu_torch.core.check", "lpopc_tpu_torch.utils.checkpoint",
            "lpopc_tpu_torch.utils.report", "lpopc_tpu_torch.utils.resultfiles",
            "lpopc_tpu_torch.utils.plot", "lpopc_tpu_torch.parallel.segment",
            "lpopc_tpu_torch.parallel.hybrid", "lpopc_tpu_torch.parallel.distributed",
            } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'lpopc_tpu' or m.startswith('lpopc_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_neither_jax_nor_the_jax_package_in_imports():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "lpopc_tpu_torch")):
        files += [os.path.join(base, f) for f in names if f.endswith(".py")]
    for path in files:
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                head = s.split()[1]
                assert head.split(".")[0] not in ("jax", "jaxlib", "lpopc_tpu"), (path, s)


def test_chip_smoke_fails_loudly_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_device_none_means_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is honoured")
    from lpopc_tpu_torch.models import brachistochrone
    from lpopc_tpu_torch.parallel.batch import make_batch_solver
    from lpopc_tpu_torch.utils.convert import inputs_from_reference
    from lpopc_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch_solver(brachistochrone.make_problem(degrees=(3, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        inputs_from_reference(*[[0.0]] * 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("model", sorted(m for m, f in MULTIPHASE_MODELS.items() if f))
def test_model_solve_device_none_raises_without_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is honoured")
    import importlib

    mod = importlib.import_module(f"lpopc_tpu_torch.models.{model}")
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(mod, MULTIPHASE_MODELS[model])()
    if model == "goddard":
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.solve()


@pytest.mark.parametrize("model", ["goddard", "tumor"])
def test_solve_auto_is_a_stub_naming_its_item(model):
    """Ported: ``solve_auto`` is no stub now. ``device=None`` means cuda, so
    without one it raises before any solve, for both methods."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is honoured")
    import importlib

    mod = importlib.import_module(f"lpopc_tpu_torch.models.{model}")
    for method in ("decompose", "continuation"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.solve_auto(device=None, method=method)


def test_kernel_wrappers_never_fall_back_for_a_non_cpu_tensor():
    from lpopc_tpu_torch.ops import batched_linalg as bl

    K = torch.zeros(2, 3, 3, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        bl.lane_cholesky(K)
    with pytest.raises(RuntimeError, match="unsupported device"):
        bl.lane_cho_solve(K, torch.zeros(2, 3, dtype=torch.float64, device="meta"))
