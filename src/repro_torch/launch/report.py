"""Policy explain report: render a deployed ``PolicyArtifact`` as markdown
(port of ``repro/launch/report.py``; the same markdown for the same artifact).

    PYTHONPATH=src python -m repro_torch.launch.report policy.json [--out report.md]

Answers "why does this deployment look the way it does" from the artifact
alone: no model, no engine, no re-search.  A v6 artifact's ``provenance``
supplies the search history (per-phase iteration counts, zone decisions,
per-layer sigma/KL sensitivity), and an artifact whose
``meta["calibration"]`` was filled by a serving run also renders the
predicted-against-measured table.  Pre-v6 artifacts still render the policy,
budget and cost sections, with the provenance sections noted absent.

Imports only the standard library and ``repro_torch.core`` /
``repro_torch.obs``: no torch work, and no card.
"""
from __future__ import annotations

import argparse

from repro_torch.core.policy import PolicyArtifact
from repro_torch.obs.calibration import render_calibration_table


def _fmt(v, nd: int = 4) -> str:
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _policy_table(policy, prov_layers: dict, title: str) -> list[str]:
    """Per-layer table: bits from the policy, sigma/sensitivity/cost-share
    from the matching provenance layer records ("—" when absent)."""
    lines = [f"### {title}",
             "",
             f"mean bits: **{policy.mean_bits():.2f}**  "
             f"(act bits {policy.act_bits})",
             "",
             "| layer | kind | bits | sigma | sensitivity | cost share |",
             "|---|---|---:|---:|---:|---:|"]
    for l in policy.layers:
        rec = prov_layers.get(l.name)
        sigma = _fmt(rec["sigma"]) if rec else "—"
        sens = _fmt(rec["sensitivity"]) if rec else "—"
        share = f"{rec['cost_share']:.1%}" if rec else "—"
        lines.append(f"| {l.name} | {l.kind} | {policy.bits[l.name]} "
                     f"| {sigma} | {sens} | {share} |")
    return lines + [""]


def _budget_section(artifact: PolicyArtifact) -> list[str]:
    b = artifact.budget
    if b is None:
        return ["_no budget recorded (hand-made artifact)_", ""]
    lines = [f"quality target: acc >= {_fmt(b.acc_t)} "
             f"(buffer {_fmt(b.acc_buffer)})",
             "",
             "| metric | limit | buffer | strict | final | headroom |",
             "|---|---:|---:|---|---:|---:|"]
    for it in b.items:
        final = artifact.report.get(it.metric)
        head = (f"{(it.limit - final) / it.limit:.1%}"
                if final is not None and it.limit else "—")
        lines.append(f"| {it.metric} | {_fmt(it.limit)} | {_fmt(it.buffer)} "
                     f"| {'yes' if it.strict else 'no'} "
                     f"| {_fmt(final) if final is not None else '—'} "
                     f"| {head} |")
    return lines + [""]


def _phase_section(name: str, rec: dict) -> list[str]:
    lines = [f"### phase: {name}",
             "",
             f"- iterations: {rec['iterations']} "
             f"({', '.join(f'{k}: {v}' for k, v in sorted(rec.get('iteration_counts', {}).items()))})",
             f"- wall: {_fmt(rec.get('wall_s', 0.0))}s "
             f"(env calls {_fmt(rec.get('env_s', 0.0))}s)",
             f"- outcome: success={rec.get('success')} "
             f"abandoned={rec.get('abandoned')} acc={_fmt(rec.get('acc'))}",
             f"- report digest: `{rec['digest']}`",
             ""]
    history = rec.get("history") or []
    if history:
        lines += ["| step | zone | acc | worst violation | note |",
                  "|---:|---|---:|---|---|"]
        for h in history:
            viol = h.get("violations") or {}
            worst = (max(viol, key=viol.get) + f" +{viol[max(viol, key=viol.get)]:.1%}"
                     if viol else "—")
            lines.append(f"| p{h['phase']}.{h['step']} | {h['zone']} "
                         f"| {_fmt(h['acc'])} | {worst} | {h['note']} |")
        lines.append("")
    return lines


def render_report(artifact: PolicyArtifact) -> str:
    """The full explain report for one artifact, as a markdown string."""
    prov = artifact.provenance or {}
    phases = prov.get("phases", {})
    meta = artifact.meta or {}

    out = [f"# Policy report — {meta.get('arch', 'unknown arch')}",
           "",
           f"- artifact version: v{artifact.version}"
           + ("" if artifact.provenance is not None
              else " (pre-v6: no search provenance)"),
           f"- cost backend: `{artifact.backend or 'unknown'}`",
           f"- registry hash: `{artifact.registry_hash}`",
           ""]

    out += ["## Budget", ""] + _budget_section(artifact)

    out += ["## Final cost vector", "",
            "| metric | value |", "|---|---:|"]
    out += [f"| {m} | {_fmt(v)} |" for m, v in artifact.report.items()]
    out.append("")

    out += ["## Policies", ""]
    out += _policy_table(artifact.policy,
                         {l["name"]: l for l in
                          (phases.get("weight", {}).get("layers") or [])},
                         "Weight policy")
    if artifact.state_policy is not None:
        out += _policy_table(artifact.state_policy,
                             {l["name"]: l for l in
                              (phases.get("state", {}).get("layers") or [])},
                             "Decode-state policy")
        if artifact.pool is not None:
            out += [f"paged pool: {artifact.pool['num_blocks']} blocks x "
                    f"{artifact.pool['block']} positions", ""]
    if artifact.draft_policy is not None:
        out += _policy_table(artifact.draft_policy,
                             {l["name"]: l for l in
                              (phases.get("draft", {}).get("layers") or [])},
                             f"Draft policy (K={artifact.draft_k})")

    out += ["## Search timeline", ""]
    if phases:
        for name in ("weight", "state", "draft"):
            if name in phases:
                out += _phase_section(name, phases[name])
        for name, rec in phases.items():
            if name not in ("weight", "state", "draft"):
                out += _phase_section(name, rec)
    else:
        out += ["_no provenance recorded (pre-v6 artifact)_", ""]

    out += ["## Calibration (predicted vs measured)", ""]
    cal = meta.get("calibration")
    if cal:
        out += [render_calibration_table(cal), ""]
    else:
        out += ["_no serving measurements attached — predicted costs only "
                "(run the engine and `attach_calibration`)_", ""]

    if prov:
        out += ["## Provenance", "",
                f"- seed: {prov.get('seed')}",
                f"- limits: {prov.get('limits')}",
                f"- controller config: {prov.get('config')}",
                ""]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("artifact", help="policy artifact JSON (launch/search.py --out)")
    ap.add_argument("--out", default=None,
                    help="write the markdown here instead of stdout")
    args = ap.parse_args(argv)
    md = render_report(PolicyArtifact.load(args.artifact))
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
        print(f"policy report -> {args.out}")
    else:
        print(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
