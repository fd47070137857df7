"""``reference.common.cached_attention`` against the cache worked one append at a time."""
import math

import torch

from . import _paths  # noqa: F401
from portbench.reference import common


def _naive(q_dec, k_pre, v_pre, k_dec, v_dec, n_head, n_dec, kb, vb):
    out = torch.zeros_like(q_dec)
    blk = common.KV_BLOCK
    g = q_dec.shape[2] // k_pre.shape[2]
    for r in range(q_dec.shape[0]):
        h0, nd = int(n_head[r]), int(n_dec[r])
        size = -(-(h0 + nd) // blk) * blk + blk
        cache = {}
        for side, pre, bits in (("k", k_pre, kb), ("v", v_pre, vb)):
            x = torch.zeros((size, pre.shape[2], pre.shape[3]))
            x[:h0] = pre[r, :h0]
            x = x.view(-1, blk, *x.shape[1:]).permute(0, 2, 1, 3)       # (nb, H, 16, hd)
            cache[side] = common._block_quant(x, bits)
        for j in range(nd):
            p = h0 + j
            b, off = divmod(p, blk)
            for side, new, bits in (("k", k_dec, kb), ("v", v_dec, vb)):
                blkv = cache[side][b].clone()
                blkv[:, off:] = 0.0
                blkv[:, off] = new[r, j]
                cache[side][b] = common._block_quant(blkv[None], bits)[0]
            keys = cache["k"].permute(1, 0, 2, 3).reshape(k_pre.shape[2], -1, k_pre.shape[3])
            vals = cache["v"].permute(1, 0, 2, 3).reshape(k_pre.shape[2], -1, k_pre.shape[3])
            keys = keys[:, :p + 1].repeat_interleave(g, 0)
            vals = vals[:, :p + 1].repeat_interleave(g, 0)
            s = torch.einsum("hd,hkd->hk", q_dec[r, j], keys) / math.sqrt(q_dec.shape[-1])
            out[r, j] = torch.einsum("hk,hkd->hd", torch.softmax(s, -1), vals)
    return out


def test_cached_attention_equals_the_appends_one_at_a_time():
    g = torch.Generator().manual_seed(0)
    n_head = torch.tensor([5, 40, 0, 17])
    n_dec = torch.tensor([30, 3, 9, 16])                  # the longest head decodes least
    r, jmax, hk, hq, hd = 4, 30, 2, 4, 8
    q = torch.randn((r, jmax, hq, hd), generator=g)
    k_pre, v_pre = (torch.randn((r, 48, hk, hd), generator=g) for _ in range(2))
    k_dec, v_dec = (torch.randn((r, jmax, hk, hd), generator=g) for _ in range(2))
    got = common.cached_attention(q, k_pre, v_pre, k_dec, v_dec, n_head, n_dec, 8, 4)
    want = _naive(q, k_pre, v_pre, k_dec, v_dec, n_head, n_dec, 8, 4)
    for i in range(r):
        n = int(n_dec[i])
        assert torch.allclose(got[i, :n], want[i, :n], rtol=1e-5, atol=1e-5)
