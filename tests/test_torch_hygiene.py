"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` — not even one of
its numpy-only modules, since ``repro/core/__init__.py`` pulls in the trainer
and JAX with it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str | None) -> bool:
    return module is not None and any(
        module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    """Every module a file imports, statically or by a constant string."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES[:-1]}
    for must in ("kernels/pinn_mlp.py", "kernels/ops.py", "serve/engine.py",
                 "launch/serve_field.py", "checkpoint/ckpt.py",
                 "core/trainer.py", "core/losses.py", "core/halo.py",
                 "data/points.py", "optim/adam.py", "launch/quickstart.py",
                 "models/causal_lm.py", "models/mla.py", "models/moe.py",
                 "models/zamba.py",
                 "kernels/flash_attention.py",
                 "kernels/wkv6.py", "launch/serve.py",
                 "runtime/failures.py", "runtime/chaos.py",
                 "runtime/elastic.py", "runtime/supervisor.py",
                 "optim/compress.py", "launch/mesh.py", "launch/train.py",
                 "optim/lbfgs.py", "obs/profiling.py",
                 "launch/inverse_heat_map.py",
                 "launch/navier_stokes_cavity.py", "models/sharding.py",
                 "launch/dryrun.py", "utils/__init__.py",
                 "utils/collectives.py", "models/expert_parallel.py",
                 "models/partition.py"):
        assert must in names
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core") and not _forbidden("jaxtyping_x")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch.')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 20


def test_sharding_rules_are_a_torch_free_copy():
    """``models/sharding.py`` imports neither torch nor JAX, and its rule
    tables are the reference's, for every combination of ``rules_for``."""
    import itertools

    from repro.models import sharding as ref
    from repro_torch.models import sharding as port

    assert not [m for m in _imports(PORT / "models" / "sharding.py")
                if m.split(".")[0] in ("torch", "jax", "repro")]
    for name in ("SINGLE_POD_RULES", "MULTI_POD_RULES", "DECODE_OVERRIDES",
                 "LONG_CONTEXT_OVERRIDES"):
        assert getattr(port, name) == getattr(ref, name), name
    for flags in itertools.product((False, True), repeat=3):
        assert port.rules_for(*flags) == ref.rules_for(*flags), flags
