"""The sync and rowsplit schedules' grid: the row tiles each prime gets
(ntt_ct_cuda.sync_tiles, the mirror of ct_ntt.cu's rule), against the
grid of ceil(slots / L) tiles a prime that it replaced, on the launches
of the benchmark cells' mul+relin and over a sweep of shapes.  No card:
the card's side (fsi_ct_tiles, the grids of a mul+relin's launches) is
in test_torch_cuda.py."""
import pytest

from bench_port import cell as cells
from bench_port import program
from fhe_si_tpu_torch.ops import ntt_ct, ntt_ct_cuda

H100_SLOTS = 132        # SMs of an H100 SXM, one 221 KB / 160 KB block each
TRANSFORMS = ("ct_fwd", "ct_fwd_digits", "ct_inv")

# (rows, L) of each sync launch of a 64-pair mul+relin -> sync_tiles at
# 132 slots: m = 2^15 (digits 1920 x 13, forward 256 x 23, inverses
# 192 x 23 and 128 x 13), m = 20480 (digits 768 x 8, forward 256 x 12,
# inverses 192 x 12 and 128 x 8)
TABLE = [pytest.param((1920, 13, 10), id="wide-digits"),
         pytest.param((256, 23, 11), id="wide-fwd"),
         pytest.param((192, 23, 11), id="wide-inv-full"),
         pytest.param((128, 13, 10), id="wide-inv-ksw"),
         pytest.param((768, 8, 16), id="mixed-digits"),
         pytest.param((256, 12, 11), id="mixed-fwd"),
         pytest.param((192, 12, 11), id="mixed-inv-full"),
         pytest.param((128, 8, 16), id="mixed-inv-ksw")]


def _cost(rows, L, slots, tiles):
    """Waves x (rows a block + 1) of the grid that `tiles` tiles a prime
    give: the rows an SM of the last wave runs, and its table load."""
    n, per_tile = ntt_ct_cuda.tile_grid(rows, tiles)
    return -(-L * n // slots) * (per_tile + 1)


def _ceil_tiles(L, slots):
    return -(-slots // L)


def _changed(rows, L, slots):
    new = ntt_ct_cuda.tile_grid(rows, ntt_ct_cuda.sync_tiles(rows, L, slots))
    return new != ntt_ct_cuda.tile_grid(rows, _ceil_tiles(L, slots))


@pytest.mark.parametrize("case", TABLE)
def test_sync_tiles_on_the_cells_launches(case):
    rows, L, want = case
    assert ntt_ct_cuda.sync_tiles(rows, L, H100_SLOTS) == want


@pytest.mark.parametrize("slots", [132, 264])
def test_sync_tiles_never_costs_more_than_ceil(slots):
    """Over rows 1..300, 768, 1920 and 6144 and L 1..40, the rule's grid
    costs no more waves x (rows a block + 1) than ceil(slots / L) tiles a
    prime, and its tiles lie in 1 .. min(rows, slots)."""
    for rows in [*range(1, 301), 768, 1920, 6144]:
        for L in range(1, 41):
            t = ntt_ct_cuda.sync_tiles(rows, L, slots)
            assert 1 <= t <= min(rows, slots)
            assert _cost(rows, L, slots, t) <= \
                _cost(rows, L, slots, _ceil_tiles(L, slots)), (rows, L)


def test_sync_tiles_waves_at_the_wide_cell():
    """At m = 2^15 the ceil grid runs a short second wave on each launch;
    the rule's digits and ksw inverse fit one wave, its forward and full
    inverse two whole ones of 24 and 18 rows a block."""
    got = {}
    for rows, L in ((1920, 13), (256, 23), (192, 23), (128, 13)):
        for rule, tiles in (("ceil", _ceil_tiles(L, H100_SLOTS)),
                            ("sync", ntt_ct_cuda.sync_tiles(rows, L,
                                                            H100_SLOTS))):
            n, per_tile = ntt_ct_cuda.tile_grid(rows, tiles)
            got[rule, rows] = (n, per_tile, -(-L * n // H100_SLOTS))
    assert got == {("ceil", 1920): (11, 175, 2), ("sync", 1920): (10, 192, 1),
                   ("ceil", 256): (6, 43, 2), ("sync", 256): (11, 24, 2),
                   ("ceil", 192): (6, 32, 2), ("sync", 192): (11, 18, 2),
                   ("ceil", 128): (11, 12, 2), ("sync", 128): (10, 13, 1)}


def _step_launches(ctx, pairs):
    """(transform, rows, L) of each transform launch of a mul+relin of
    `pairs` pairs: 4 lifted parts forward, 3 x ndigits digit rows on the
    keyswitch basis, 3 tensored parts back, 2 keyswitched parts back."""
    L, Lk = ctx.num_primes, len(ctx.ksw_rows)
    return [("ct_fwd", 4 * pairs, L),
            ("ct_fwd_digits", 3 * ctx.ndigits * pairs, Lk),
            ("ct_inv", 3 * pairs, L), ("ct_inv", 2 * pairs, Lk)]


@pytest.mark.parametrize("cell, want", [
    pytest.param("ct32768_q220w.b64", (1, 1, 2), id="m32768"),
    pytest.param("mixed20480_q80.b64", (0, 1, 0), id="m20480"),
    pytest.param("ct8192_q80.b64", (0, 0, 0), id="m8192")])
def test_rebalanced_launches_of_the_cells(cell, want):
    """The launches of a 64-pair mul+relin whose grid the rule changes at
    132 slots, as the card's launch_grid reads them: 1, 1, 2 at m = 2^15
    (the rowsplit schedule, on sync_tiles' grid as the sync schedule),
    0, 1, 0 at m = 20480 (the sync schedule), none at m = 8192, whose
    splits the ping-pong takes (its grid is not the rule's)."""
    c = cells.load(cell)
    ctx = program.context(c.config)
    N1, N2 = ntt_ct._split(ctx.m // 2)
    schedules = {ntt_ct_cuda.kernel_schedule(N2, N1),
                 ntt_ct_cuda.kernel_schedule(N1, N2)}
    assert schedules == {{8192: "pingpong", 32768: "rowsplit"}.get(ctx.m,
                                                                  "sync")}
    got = dict.fromkeys(TRANSFORMS, 0)
    for name, rows, L in _step_launches(ctx, c.traffic["pairs_per_call"]):
        got[name] += (schedules != {"pingpong"}
                      and _changed(rows, L, H100_SLOTS))
    assert tuple(got.values()) == want

