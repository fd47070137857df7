"""CPU smoke test of ``examples/torch_budget_search_serve.py``, the twin of
``tests/test_examples.py``: the full search -> artifact -> serve demo on the
port (all three hardware conditions, the KV-budgeted one on the paged block
pool, and the speculative fourth) runs end to end with ``--device cpu``,
makes every assertion of the JAX example's test, and writes artifacts the
JAX package's ``PolicyArtifact`` loads field for field."""
import json
import os
import pathlib
import sys

from repro.core.policy import PolicyArtifact as JPolicyArtifact

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def test_budget_search_serve_tiny(capsys, tmp_path):
    sys.path.insert(0, str(EXAMPLES))
    try:
        import torch_budget_search_serve
    finally:
        sys.path.pop(0)

    trace_path = tmp_path / "serve_trace.json"
    out_dir = torch_budget_search_serve.main(["--tiny", "--paged", "--speculate",
                                              "--trace", str(trace_path), "--device", "cpu"])
    stdout = capsys.readouterr().out
    # --trace wrote a valid Perfetto document for the condition-3 serve
    assert "traced:" in stdout
    from repro_torch.obs.trace import validate_chrome_trace
    validate_chrome_trace(json.loads(trace_path.read_text()))
    # all three conditions produced artifacts on disk
    for name in ("policy_memory_tight.json", "policy_latency_tight.json",
                 "policy_kv_budgeted.json"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    # the KV condition searched, reported the reduction, and served
    assert "[kv-budgeted/shift_add]" in stdout
    assert "served 3 requests on the quantized KV cache" in stdout
    # the --paged scenario deployed the pool and beat the dense container
    assert "[paged] pool" in stdout
    assert "less state memory" in stdout
    # the CLI deployments ran for the other two conditions
    assert stdout.count("launch.serve --policy") == 2

    from repro_torch.core.policy import ARTIFACT_VERSION, PolicyArtifact

    art = PolicyArtifact.load(os.path.join(out_dir, "policy_kv_budgeted.json"))
    assert art.state_policy is not None
    assert art.report["state_bytes"] > 0
    # v3: the pool geometry the state budget bought rides in the artifact
    assert art.pool is not None and art.pool["num_blocks"] >= 1
    # v4/v5 fields (draft policy, kernel configs) ride along, None here
    assert art.version == ARTIFACT_VERSION
    # --speculate: the condition-4 artifact additionally carries the draft,
    # and the engine served speculatively from it
    assert "[speculative] draft mean_bits=" in stdout
    spec = PolicyArtifact.load(os.path.join(out_dir, "policy_speculative.json"))
    assert spec.draft_policy is not None and spec.draft_k == 2
    assert spec.state_policy is not None
    # the pool grew by the burst-scratch headroom (attach_draft)
    assert spec.pool["block"] == art.pool["block"]
    assert spec.pool["num_blocks"] > art.pool["num_blocks"]
    assert spec.meta["draft_pool_headroom_blocks"] > 0

    # every artifact loads in the JAX package with the same fields
    for name in ("policy_memory_tight.json", "policy_latency_tight.json",
                 "policy_kv_budgeted.json", "policy_speculative.json"):
        text = pathlib.Path(out_dir, name).read_text()
        back = JPolicyArtifact.from_json(text)
        mine = PolicyArtifact.from_json(text)
        assert back.version == mine.version == ARTIFACT_VERSION, name
        assert back.registry_hash == mine.registry_hash and back.policy.bits == mine.policy.bits
        assert back.pool == mine.pool and back.draft_k == mine.draft_k
        assert (back.state_policy is None) == (mine.state_policy is None)
        if mine.state_policy is not None:
            assert back.state_policy.bits == mine.state_policy.bits
        assert json.loads(back.to_json()) == json.loads(mine.to_json()), name


def test_train_lm_qat_survives_the_injected_failure(capsys):
    """``examples/torch_train_lm_qat.py`` at its README size on the CPU: the
    JAX example's printed lines (one injected failure recovered, the loss
    near ln(vocab) with the same warm-up learning rates, the task's entropy
    floor)."""
    import math
    import re

    sys.path.insert(0, str(EXAMPLES))
    try:
        import torch_train_lm_qat
    finally:
        sys.path.pop(0)

    loop = torch_train_lm_qat.main(["--steps", "4", "--seq", "16", "--batch", "2",
                                    "--fail-at", "2", "--device", "cpu"])
    stdout = capsys.readouterr().out
    assert "QAT W8A8" in stdout and "restarts survived: 1" in stdout
    assert loop.restarts == 1
    rows = re.findall(r"^  step +(\d+)  loss (\S+)  lr (\S+)$", stdout, re.M)
    assert [lr for _, _, lr in rows] == ["1.50e-05", "4.50e-05"]
    assert all(abs(float(loss) - math.log(32_000)) < 0.5 for _, loss, _ in rows)
    assert "task entropy floor: 1.886" in stdout


def test_elastic_remesh_resumes_on_the_replanned_mesh():
    """``examples/torch_elastic_remesh.py --device cpu``: 8 gloo ranks on
    (4, 2), the data-parallel gradient of step 0 equal to the single-process
    full-batch gradient (rtol 1e-4, atol 1e-6, asserted by the example), 4
    ranks lost, re-planned to (2, 2), resumed at step 10 from the checkpoint."""
    import subprocess

    out = subprocess.run([sys.executable, str(EXAMPLES / "torch_elastic_remesh.py"), "--device",
                          "cpu"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "initial mesh plan: (4, 2) ('data', 'model')" in text
    assert "backend: gloo, 8 ranks on cpu" in text
    assert "data-parallel gradient of step 0 = the full-batch gradient" in text
    assert "4 devices lost -> replanned mesh: (2, 2) ('data', 'model')" in text
    assert "step 10-19 on (2, 2)" in text and "resumed cleanly at step 10" in text
