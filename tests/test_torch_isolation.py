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
            "repro_torch.serve.scheduler", "repro_torch.serve.lifecycle",
            "repro_torch.runtime", "repro_torch.runtime.resilience",
            "repro_torch.obs.calibration", "repro_torch.obs.trace",
            "repro_torch.roofline.model", "repro_torch.cost.roofline",
            "repro_torch.quant.calibration", "repro_torch.core.baselines",
            "repro_torch.checkpoint.store", "repro_torch.launch.report",
            "repro_torch.launch.train", "repro_torch.runtime.loop",
            "repro_torch.runtime.elastic", "repro_torch.models.moe",
            "repro_torch.models.mamba2", "repro_torch.models.layers",
            "repro_torch.models.hybrid", "repro_torch.models.encdec",
            "repro_torch.models.decoder", "repro_torch.models.registry",
            "repro_torch.data.pipeline", "repro_torch.serve.engine",
            "repro_torch.train.train_step", "repro_torch.quant.env",
            "repro_torch.kernels.autotune", "repro_torch.core.hardware",
            "repro_torch.dist.sharding", "repro_torch.dist.expert_parallel",
            "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun", "repro_torch.roofline.extract",
            "repro_torch.roofline.hlo_cost", "repro_torch.roofline.reprice"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized(), 'an import started a process group'\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("*.py")) + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    assert path.exists(), path
    bad = FORBIDDEN.findall(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_examples_import_without_jax():
    """The port's examples import with JAX and the JAX package blocked."""
    assert [p.name for p in EXAMPLES] == ["torch_budget_search_serve.py", "torch_elastic_remesh.py",
                                          "torch_quickstart.py", "torch_serve_quantized.py",
                                          "torch_train_lm_qat.py"]
    code = ("import importlib.util, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_examples_without_device_raise_when_no_card(monkeypatch):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_serve_quantized
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_serve_quantized.main([])


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


def test_expert_matmul_on_cpu_tensors_never_launches():
    """The MoE expert stacks: "auto" on CPU tensors is the plain version,
    "cuda" on them raises, and no kernel is built."""
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant_matmul.ops import qt_matmul
    from repro_torch.quant.tensor import quantize_tensor

    qt = quantize_tensor(torch.randn((4, 64, 16)), 4)
    kernels.reset_counts()
    for c in (8, 16):
        assert qt_matmul(torch.randn((4, c, 64)), qt).shape == (4, c, 16)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            qt_matmul(torch.randn((4, c, 64)), qt, impl="cuda")
    assert kernels.PLAIN_CALLS["quant_gemv_experts"] == kernels.PLAIN_CALLS[
        "quant_matmul_experts"] == 1
    assert sum(kernels.LAUNCHES.values()) == 0 and _build._lib is None


def test_kernel_build_is_not_started_by_imports():
    from repro_torch.kernels import _build
    assert _build._lib is None
    assert all(p.suffix in (".cu", ".cuh") for p in _build.sources())
    assert {p.name for p in _build.sources()} >= {
        "quant_gemv.cu", "quant_matmul.cu", "quant_kv_decode_step.cu", "quant_kv_dense.cu",
        "quant_kv_paged.cu", "quant_kv.cuh", "fake_quant.cu", "quant_gemv.cuh",
        "quant_kv_proj.cu", "wgmma.cuh"}


@pytest.mark.parametrize("port,ref", [("runtime/resilience.py", "runtime/resilience.py"),
                                      ("runtime/elastic.py", "runtime/elastic.py"),
                                      ("obs/calibration.py", "obs/calibration.py"),
                                      ("obs/trace.py", "obs/trace.py")])
def test_copied_modules_keep_the_references_code(port, ref):
    """The port keeps its own copy of these JAX-free reference modules: the
    same code below the module docstring, so the two cannot drift apart."""
    def body(path):
        text = path.read_text()
        return text[text.index('"""', 3) + 3:]

    assert body(PORT / port) == body(ROOT / "src" / "repro" / ref)


def test_new_families_on_cpu_tensors_never_launch(monkeypatch):
    """The stacked experts' fake-quant and the SSM and VLM families: "auto"
    on CPU tensors runs the plain versions, "cuda" on them raises, no kernel
    is built, and without a card the engine raises unless asked for the CPU."""
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.kernels.fake_quant.ops import fake_quant_ste

    kernels.reset_counts()
    stack = torch.randn((4, 8, 16))
    assert fake_quant_ste(stack, 4).shape == stack.shape
    with pytest.raises(ValueError, match="CUDA"):
        fake_quant_ste(stack, 4, "cuda")
    assert kernels.PLAIN_CALLS["fake_quant"] == 1
    assert sum(kernels.LAUNCHES.values()) == 0 and _build._lib is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("mamba2-2.7b", "qwen2-vl-2b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(configs.get_config(arch).reduced(), {})
