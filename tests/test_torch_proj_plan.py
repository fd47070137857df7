"""The partition of row 8's projection over a cluster, on the CPU.

``csrc/quant_kv_proj.cu`` runs one thread-block cluster per (slot, kv
head); rank r projects its share of the (g + 2) * hd rows of ``wqkv`` that
the kv head reads, in whole 16-row tiles (``kernels/quant_kv/kernel.py``
``proj_tiles``), and the ranks exchange the rows through distributed shared
memory, each reading a tile from the rank the kernel's owner formula names.
The card runs it; these tests hold what the CPU can check: that the shares
cover each row exactly once in whole tiles at every cluster size 1-16, that
the owner formula names the rank whose share holds the tile, that the rows
are the slices of ``wqkv`` the JAX package's BlockSpecs give the kv head,
and that the projections of the ranks' shares, put in place, are the plain
composition's query group and K and V rows bit for bit (the GEMV's CPU
mirror, whose value for a channel does not depend on the other channels).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels.quant_gemv.ref import quant_gemv_mirror
from repro_torch.kernels.quant_kv import kernel as kvk
from repro_torch.quant.tensor import quantize_tensor

torch.set_num_threads(2)

#: (n_heads, n_kv, hd): gemma-2b's heads; tests/test_torch_proj.py's parity
#: shapes (its JAX parity test's) and its engine's reduced gemma-2b at head_dim
#: 64; the reduced gemma-2b config; the card tests' two-kv-head geometry
_R = tconfigs.get_config("gemma-2b").reduced()
GEOMS = {"gemma-2b": (8, 1, 256), "parity": (4, 2, 16),
         "engine": (_R.n_heads, _R.n_kv_heads, 64),
         "reduced": (_R.n_heads, _R.n_kv_heads, _R.resolved_head_dim), "two_heads": (4, 2, 32)}


def _blockspec_rows(h: int, n_heads: int, n_kv: int, hd: int) -> list[int]:
    """The rows of ``wqkv`` that ``quant_kv_decode_step_proj_pallas``'s BlockSpecs
    (``repro/kernels/quant_kv/kernel.py``) hand grid column h: block
    h of g * hd rows, block n_heads + h of hd rows, block n_heads + n_kv + h of hd."""
    g = n_heads // n_kv
    return (list(range(h * g * hd, (h + 1) * g * hd))
            + list(range((n_heads + h) * hd, (n_heads + h + 1) * hd))
            + list(range((n_heads + n_kv + h) * hd, (n_heads + n_kv + h + 1) * hd)))


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_each_rank_projects_whole_tiles_and_every_row_once(geom):
    n_heads, n_kv, hd = GEOMS[geom]
    rows = (n_heads // n_kv + 2) * hd
    t = rows // kvk.PROJ_TILE
    assert rows % kvk.PROJ_TILE == 0
    for cluster in range(1, kvk.MAX_CLUSTER + 1):
        shares = [kvk.proj_tiles(n_heads, n_kv, hd, cluster, r) for r in range(cluster)]
        assert all(s.step == 1 for s in shares)
        # the shares are whole tiles in order: rank r's follow rank r - 1's
        assert shares[0].start == 0 and shares[-1].stop == t
        assert all(a.stop == b.start for a, b in zip(shares, shares[1:]))
        cover = np.zeros(rows, np.int64)
        for r, share in enumerate(shares):
            for tile in share:
                cover[tile * kvk.PROJ_TILE:(tile + 1) * kvk.PROJ_TILE] += 1
                # the kernel's exchange reads tile t from rank ((t + 1) * cluster - 1) // T
                assert ((tile + 1) * cluster - 1) // t == r
            # as even as whole tiles allow
            assert len(share) in (t // cluster, -(-t // cluster))
        assert (cover == 1).all(), (geom, cluster)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_projected_rows_are_the_blockspec_slices_of_wqkv(geom):
    """Over every kv head, each row of ``wqkv`` is projected once, by the head
    whose BlockSpecs (``repro/kernels/quant_kv/kernel.py``) slice it."""
    n_heads, n_kv, hd = GEOMS[geom]
    g = n_heads // n_kv
    seen = []
    for h in range(n_kv):
        got = [kvk.proj_row(r, h, n_heads, n_kv, hd) for r in range((g + 2) * hd)]
        assert got == _blockspec_rows(h, n_heads, n_kv, hd)
        seen += got
    assert sorted(seen) == list(range((n_heads + 2 * n_kv) * hd))


@pytest.mark.parametrize("w_bits", (2, 4, 8))
@pytest.mark.parametrize("geom", ("parity", "two_heads", "engine"))
def test_the_ranks_shares_assemble_the_plain_split(geom, w_bits):
    """Each rank's tiles projected alone (the GEMV's CPU mirror, f32 x, K 128
    in one range) and put at their rows: every kv head's buffer equals its
    query group, K row and V row cut from the whole projection, bit for bit,
    at cluster sizes 1, 3, 8 and 16."""
    n_heads, n_kv, hd = GEOMS[geom]
    g, d, b = n_heads // n_kv, 128, 3
    rng = np.random.default_rng(w_bits)
    n = (n_heads + 2 * n_kv) * hd
    wq = quantize_tensor(torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32) * 0.1),
                         w_bits)
    x = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    y = quant_gemv_mirror(x, wq.packed, wq.scale, w_bits, d)              # (B, N)
    nq = n_heads * hd
    for h in range(n_kv):
        want = torch.cat([y[:, h * g * hd:(h + 1) * g * hd],              # the query group
                          y[:, nq + h * hd:nq + (h + 1) * hd],            # K head h
                          y[:, nq + (n_kv + h) * hd:nq + (n_kv + h + 1) * hd]], dim=1)
        for cluster in (1, 3, 8, 16):
            buf = torch.full((b, (g + 2) * hd), float("nan"))
            for r in range(cluster):
                for tile in kvk.proj_tiles(n_heads, n_kv, hd, cluster, r):
                    rows = range(tile * kvk.PROJ_TILE, (tile + 1) * kvk.PROJ_TILE)
                    src = torch.tensor([kvk.proj_row(i, h, n_heads, n_kv, hd) for i in rows])
                    buf[:, rows.start:rows.stop] = quant_gemv_mirror(
                        x, wq.packed[src], wq.scale.reshape(-1)[src], w_bits, d)
            assert torch.equal(buf, want), (geom, h, cluster)


def test_row8_takes_row3s_plan_and_its_projection_tiles_fit_the_kernel():
    """At gemma-2b's max_seq 512 and 1024 the plan gives clusters of 8 and
    16, and each rank then projects 20 and 10 of the 160 tiles."""
    n_heads, n_kv, hd = GEOMS["gemma-2b"]
    for s, cluster, share in ((512, 8, 20), (1024, 16, 10)):
        p = kvk.attend_plan("quant_kv_decode_step_proj", s, 16)
        assert p == kvk.attend_plan("quant_kv_decode_step", s, 16)
        assert p.cluster == cluster and p.mode == "cluster"
        assert {len(kvk.proj_tiles(n_heads, n_kv, hd, cluster, r))
                for r in range(cluster)} == {share}
    assert kvk.attend_plan("quant_kv_decode_step_proj", 1152, 48).mode == "walk"
