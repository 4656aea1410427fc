"""The PyTorch port stands alone: importing ``repro_torch`` and every module
under it, or running ``chip_smoke.py``, loads neither ``jax`` nor anything of
the JAX package ``repro``; and ``chip_smoke.py`` refuses to report without a
card."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(SRC)
    return env


def test_importing_every_port_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py"] + list((SRC / "repro_torch").rglob("*.py"))),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, roots


@pytest.mark.parametrize("alone", [False, True], ids=["in_checkout", "alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """On a machine without CUDA — and in a directory holding nothing of the
    repo but the script — it exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         env=env, cwd=script.parent, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
