"""The port stands alone: no JAX, nothing of the JAX package, and no silent CPU fallback."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\.|from repro\.|import repro\s*$|"
                       r"from repro import)", re.M)


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_submodule_imports_without_jax():
    mods = _submodules()
    assert {"repro_torch.serve.engine", "repro_torch.kernels._build", "repro_torch.spec.draft",
            "repro_torch.spec.loop", "repro_torch.launch.serve", "repro_torch.launch.search",
            "repro_torch.core.controller", "repro_torch.kernels.fake_quant.ops",
            "repro_torch.train.optimizer", "repro_torch.obs.metrics",
            "repro_torch.serve.scheduler", "repro_torch.serve.lifecycle"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    assert path.exists(), path
    bad = FORBIDDEN.findall(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_pattern_catches_the_spellings():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.models import decoder", "from repro import configs"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import packing",
                 "import jaxlib_not_really", "from repro_torch import kernels"):
        assert not FORBIDDEN.search(line), line


def test_engine_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("gemma-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, {}, speculate=2, draft_policy=4)


def test_serve_cli_without_device_raises_when_no_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])


def test_kernel_build_is_not_started_by_imports():
    from repro_torch.kernels import _build
    assert _build._lib is None
    assert all(p.suffix in (".cu", ".cuh") for p in _build.sources())
    assert {p.name for p in _build.sources()} >= {
        "quant_gemv.cu", "quant_matmul.cu", "quant_kv_decode_step.cu", "quant_kv_dense.cu",
        "quant_kv_paged.cu", "quant_kv.cuh", "fake_quant.cu", "quant_gemv.cuh",
        "quant_kv_proj.cu", "wgmma.cuh"}
