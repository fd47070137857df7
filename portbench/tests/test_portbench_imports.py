"""Nothing the benchmark runs loads JAX or the JAX package ``repro``; the
references import nothing of the program."""
import ast
import subprocess
import sys

from . import _paths  # noqa: F401
from portbench.cell import HERE, ROOT
from portbench.run import FORBIDDEN, forbidden_modules


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_top_level_names_are_compared_whole():
    mods = ["repro_torch", "repro_torch.serve", "repro", "repro.models", "jax", "jaxlib.xla",
            "flax", "reprox", "jaxtyping"]
    assert forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla", "repro", "repro.models"]


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_references_import_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("repro_torch", "chip_smoke"), (path, name)


def test_the_measured_process_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            "from portbench import harness, check, control\n"
            "from portbench.cell import HERE\n"
            "for p in (HERE / 'metrics').glob('*.py'): harness.load_reader(p.stem)\n"
            "import repro_torch.serve.engine, repro_torch.quant.apply, repro_torch.models.registry\n"
            "from portbench.run import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "dsmoe16b.decode64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_there_is_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, str(tmp_path / "portbench" / "run.py"), "--workload",
                          "mamba2.chat64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
