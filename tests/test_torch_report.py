"""Port parity of the policy explain report (``launch/report.py``), on the CPU.

The port renders the JAX package's markdown character for character from the
same artifact JSON: a v6 artifact from either package's ``search_policy`` (a
weight phase on a synthetic env), one with state, pool and draft policies and
a calibration table, a calibration table alone, and a pre-v6 artifact; the
command lines write the same file.  The twins of
``tests/test_search_obs.py``'s ``TestExplainReport`` cases run on the port.
"""
import types

import pytest

from repro.core import policy as jpol
from repro.core.controller import ControllerConfig as JCC
from repro.launch import report as jreport
from repro.launch.search import search_policy as jsearch_policy
from repro.obs import calibration as jcal
from repro_torch.core import policy as tpol
from repro_torch.core.controller import ControllerConfig as TCC
from repro_torch.launch import report as treport
from repro_torch.launch.search import search_policy as tsearch_policy
from repro_torch.obs import calibration as tcal
from test_core_controller import SyntheticEnv, make_layers


class SynthCostEnv(SyntheticEnv):
    """SyntheticEnv + the CostModel surface ``search_policy`` needs."""

    def __init__(self, layers, seed=0, **kw):
        super().__init__(layers, seed=seed, **kw)
        self.cost_model = types.SimpleNamespace(name="synthetic")

    def costs(self, policy):
        size = policy.model_size_mib()
        return {"size_mib": size, "resource": size}


def _port_layers(n, seed=0):
    return tuple(tpol.LayerInfo(l.name, l.shape, l.macs, l.kind) for l in make_layers(n, seed))


def _searched(pkg: str, n: int = 6, seed: int = 2):
    layers = make_layers(n=n, seed=seed) if pkg == "jax" else _port_layers(n, seed)
    env = SynthCostEnv(layers, seed=seed)
    t = env.feasible_targets()
    polmod, cc, search = (jpol, JCC, jsearch_policy) if pkg == "jax" else \
        (tpol, TCC, tsearch_policy)
    budget = polmod.Budget.of(t.acc_t, acc_buffer=t.acc_buffer, buffer=t.res_buffer,
                              size_mib=t.res_t)
    return search(env, budget, config=cc(phase2_max_iters=30), seed=0,
                  meta={"arch": "synthetic"})


def _both(text: str) -> tuple[str, str]:
    return (treport.render_report(tpol.PolicyArtifact.from_json(text)),
            jreport.render_report(jpol.PolicyArtifact.from_json(text)))


@pytest.mark.parametrize("pkg", ("jax", "torch"))
def test_v6_report_equals_jax(pkg):
    artifact, _ = _searched(pkg)
    t, j = _both(artifact.to_json())
    assert t == j


def test_report_with_every_section_equals_jax():
    layers = _port_layers(5, 3)
    state = (tpol.LayerInfo("layer000.state.k", (4, 64, 1, 32), 0, "state"),
             tpol.LayerInfo("layer000.state.v", (4, 64, 1, 32), 0, "state"))
    artifact, _ = _searched("torch", n=5, seed=3)
    art = tpol.PolicyArtifact.build(
        artifact.policy, backend="roofline", report=dict(artifact.report, latency_s=1.5e-4),
        budget=artifact.budget, state_policy=tpol.BitPolicy.from_bits(
            state, {"layer000.state.k": 8, "layer000.state.v": 4}),
        pool={"block": 16, "num_blocks": 40}, draft_policy=tpol.BitPolicy.uniform(layers, 4),
        draft_k=3, provenance=artifact.provenance, meta={"arch": "gemma-2b"})
    tcal.attach_calibration(art, tcal.calibration_ratios(
        {"container_bytes": 8.0, "latency_s": 2e-4}, {"container_bytes": 8.5,
                                                      "latency_s": 3.1e-4}))
    t, j = _both(art.to_json())
    assert t == j
    assert "### Decode-state policy" in t and "paged pool: 40 blocks x 16 positions" in t
    assert "### Draft policy (K=3)" in t and "| latency_s |" in t


@pytest.mark.parametrize("bits", (2, 6))
def test_pre_v6_and_calibration_reports_equal_jax(bits):
    layers = _port_layers(4)
    art = tpol.PolicyArtifact.build(tpol.BitPolicy.uniform(layers, bits),
                                    report={"container_bytes": 8.0})
    t, j = _both(art.to_json())
    assert t == j
    tcal.attach_calibration(art, tcal.calibration_ratios({"container_bytes": 8.0},
                                                         {"container_bytes": 9.0}))
    t, j = _both(art.to_json())
    assert t == j


def test_cli_writes_the_jax_file(tmp_path, capsys):
    artifact, _ = _searched("torch")
    path = artifact.save(str(tmp_path / "p.json"))
    assert treport.main([path, "--out", str(tmp_path / "t.md")]) == 0
    assert jreport.main([path, "--out", str(tmp_path / "j.md")]) == 0
    assert (tmp_path / "t.md").read_text() == (tmp_path / "j.md").read_text()
    assert treport.main([path]) == 0
    out = capsys.readouterr().out
    assert "# Policy report — synthetic" in out


class TestExplainReport:
    """Twins of ``tests/test_search_obs.py``'s report cases, on the port."""

    def test_renders_from_v6_artifact_alone(self):
        artifact, result = _searched("torch")
        artifact = tpol.PolicyArtifact.from_json(artifact.to_json())
        md = treport.render_report(artifact)
        assert "# Policy report — synthetic" in md
        assert "## Budget" in md and "| size_mib |" in md
        assert "### Weight policy" in md and "| layer00 |" in md
        assert "### phase: weight" in md
        assert f"`{result.search_report.digest()}`" in md
        assert "- seed: 0" in md
        weight_rows = [l for l in md.splitlines() if l.startswith("| layer")]
        assert weight_rows and all("—" not in l for l in weight_rows)
        assert "no serving measurements attached" in md

    def test_calibration_table_when_attached(self):
        artifact = tpol.PolicyArtifact.build(tpol.BitPolicy.uniform(_port_layers(4), 8),
                                             report={"container_bytes": 8.0})
        tcal.attach_calibration(artifact, tcal.calibration_ratios(
            {"container_bytes": 8.0}, {"container_bytes": 8.0}))
        md = treport.render_report(artifact)
        assert "| container_bytes | 8 | 8 | 1.000 |" in md
        assert "no serving measurements attached" not in md

    def test_pre_v6_artifact_renders_with_notes(self):
        artifact = tpol.PolicyArtifact.build(tpol.BitPolicy.uniform(_port_layers(4), 6))
        assert artifact.provenance is None
        md = treport.render_report(artifact)
        assert "### Weight policy" in md
        assert "_no provenance recorded (pre-v6 artifact)_" in md
        assert "| layer00 |" in md and "| — | — | — |" in md


def test_jax_calibration_table_matches_the_ports():
    cal = {"container_bytes": {"predicted": 4.0, "measured": 5.0, "ratio": 1.25}}
    assert tcal.render_calibration_table(cal) == jcal.render_calibration_table(cal)
