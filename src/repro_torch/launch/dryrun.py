"""Representative serving policies (``dryrun_policy`` of ``repro/launch/dryrun.py``).

No searched weights exist at a dry-run, so the ``"mixed"`` policy is the
representative shape of a SigmaQuant output: the embedding and layer 0 at
8 bits, the bulk at 4, and a periodic 6-bit riser (4/4/6/4 by layer index).
"""
from __future__ import annotations

import re

from repro_torch.core.policy import BitPolicy


def dryrun_policy(specs, scheme: str) -> BitPolicy:
    if scheme.startswith("uniform"):
        return BitPolicy.uniform(specs, int(scheme.removeprefix("uniform")))
    if scheme != "mixed":
        raise ValueError(f"unknown policy scheme {scheme!r}")
    pattern = (4, 4, 6, 4)
    bits = {}
    for s in specs:
        m = re.search(r"layer(\d+)", s.name)
        if s.kind == "embedding":
            bits[s.name] = 8
        elif m and int(m.group(1)) == 0:
            bits[s.name] = 8
        else:
            bits[s.name] = pattern[(int(m.group(1)) if m else 0) % len(pattern)]
    return BitPolicy.from_bits(specs, bits)
