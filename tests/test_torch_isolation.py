"""repro_torch stands alone: it imports neither JAX nor the reference
package, and its entry points refuse to drop to the CPU unasked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_or_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: {bad}"


def test_entry_points_raise_without_a_card():
    """With no CUDA device, the default device='cuda' raises; the CPU runs
    only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_cache, init_model
    cfg = get_config("rwkv6-1.6b").reduced()
    for call in (lambda: resolve_device(), lambda: init_model(cfg),
                 lambda: init_cache(cfg, 1),
                 lambda: serve.run(["--requests", "1", "--tokens", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"
