#!/usr/bin/env python3
"""Time the quantized-KV attention kernels (rows 3, 4, 6 and 7) of one tree.

    python3 tools/attend_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and
builds its kernels there, so that two trees can be timed in one session on
one card, in turns (parent, change, change, parent).  Shapes are
chip_smoke.py phase 2's, whose helpers this script reuses: rows 3 and 4 at
B 4, S 512 (``KV``, ``KV_POS``), rows 6 and 7 at B 8, max_seq 1024 over 512
shuffled blocks (``PG``, ``PG_POS``), K 8 / V 4, bf16 q.  For each kernel
and for SDPA on the dequantized bf16 K/V it prints, in one JSON line, the
CUDA-event median of one call (``call_ms``: ``time_ms``, the wrapper's host
time included, as chip_smoke.py's ``ms``) and the device time a launch
takes back to back (``device_ms``: ``time_batch``), beside the card's name
and power limit.  Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attend_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.quant_kv import kernel as kvk
    from repro_torch.kvcache.paged import to_dense

    dt, kb, vb = torch.bfloat16, 8, 4
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {}
    for kind, c, plist in (("dense", cs.KV, cs.KV_POS), ("paged", cs.PG, cs.PG_POS)):
        layer = (cs._kv_layer(torch, gen, kb, vb, dt) if kind == "dense"
                 else cs._paged_layer(torch, gen, kb, vb))
        pos = torch.tensor(plist, dtype=torch.int32, device="cuda")
        valid = torch.arange(c["S"], device="cuda")[None, :] <= pos[:, None].long()
        mask = torch.where(valid, 0.0, -1e30).float()
        hq = c["n_kv"] * c["g"]
        q = torch.randn((c["B"], hq, c["hd"]), generator=gen, device="cuda").to(dt)
        qg = q.reshape(c["B"], c["n_kv"], c["g"], c["hd"])
        kn, vn = (torch.randn((c["B"], c["n_kv"], c["hd"]), generator=gen, device="cuda").to(dt)
                  for _ in range(2))
        pool = (layer.k_packed, layer.k_scale, layer.v_packed, layer.v_scale)
        kw = dict(k_bits=kb, v_bits=vb, hd=c["hd"], block=c["block"])
        kd, vd = (to_dense(layer) if kind == "paged" else layer).dequantize(dt)
        kd = kd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
        vd = vd.transpose(1, 2).repeat_interleave(c["g"], dim=1)
        if kind == "dense":
            fns["quant_kv_decode_step"] = partial(kvk.quant_kv_decode_step_cuda, pos, qg, kn,
                                                  vn, *pool, mask, **kw)
            fns["quant_kv_attention"] = partial(kvk.quant_kv_attention_cuda, qg, *pool, mask,
                                                **kw)
        else:
            tbl = layer.block_table
            fns["quant_kv_decode_step_paged"] = partial(kvk.quant_kv_decode_step_paged_cuda, pos,
                                                        tbl, qg, kn, vn, *pool, mask, **kw)
            fns["quant_kv_attention_paged"] = partial(kvk.quant_kv_attention_paged_cuda, tbl, qg,
                                                      *pool, mask, **kw)
        fns[f"sdpa {kind}"] = partial(sdpa, q[:, :, None, :], kd, vd,
                                      attn_mask=valid[:, None, None, :])
    times = {name: {"call_ms": cs.time_ms(torch, fn), "device_ms": cs.time_batch(torch, fn,
                                                                                 reps=20)}
             for name, fn in fns.items()}
    print(json.dumps({"label": args.label, "src": args.src, "card": cs.smi_line(),
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
