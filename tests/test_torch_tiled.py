"""The tiled route of the port's worldline sweep (``ops/wl.tiled_plan``,
``csrc/tiled.cuh``): its shape gate and route choice, and its schedule.

The gate decides by shape alone, from the opt-in shared memory per block and
the SM count that the caller passes in (232,448 bytes and 132 SMs on an
H100). The schedule is emulated here in plain torch from the constants that
``ops/wl.py`` exports (``TILE_HALO``, ``TILE_RANKS``): each tile's box (the
tile and its halo) is cut from the state a sweep starts from, each phase runs
only on its update set (its color up to its rank) with every draw at the
site's global position, the statistics and samples are taken from the
interiors, and the interiors make the next state. That emulation must equal
``wl_sweeps_reference`` bit for bit (states, int64 statistics, samples;
tolerance: none), and the same schedule with a halo one site short must not.
The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds
it to the plain version and to the multi-launch kernels bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyisingmontecarlo_tpu_torch.ops import wl
from pyisingmontecarlo_tpu_torch.ops.lanerng import lane_draw31, make_pos_mix

torch.set_num_threads(1)

H100_OPTIN, H100_SMS = 232448, 132
LOG_SCALE = 1.0 / 2147483648.0


# name, kind, size, nvars, L_tau, R, route on an H100, tile side if tiled
ROUTES = [
    ("256^2 torus L=40 R=8 (main shape)", "torus", 256, 65536, 40, 8, "tiled", 32),
    ("256-chain L=40 R=64", "ring", 256, 256, 40, 64, "resident", None),
    ("256-chain L=824 R=64", "ring", 256, 256, 824, 64, "resident", None),
    ("24^2 torus L=40 R=64 (297 idle sites)", "torus", 24, 576, 40, 64, "resident", None),
    ("24^2 torus L=40 R=264 (two full waves)", "torus", 24, 576, 40, 264, "resident", None),
    ("32^2 torus L=40 R=264 (two full waves)", "torus", 32, 1024, 40, 264, "resident", None),
    ("48^2 torus L=40 R=132 (one full wave)", "torus", 48, 2304, 40, 132, "resident", None),
    ("24^2 torus L=40 R=16 (506 idle sites)", "torus", 24, 576, 40, 16, "tiled", 8),
    ("32^2 torus L=40 R=64 (528 idle sites)", "torus", 32, 1024, 40, 64, "tiled", 16),
    ("48^2 torus L=40 R=16 (fits resident, too many idle sites)", "torus", 48, 2304, 40, 16, "tiled", 16),
    ("8192-ring L=40 R=4 (too long for resident)", "ring", 8192, 8192, 40, 4, "tiled", 128),
    ("256^2 torus L=4096 R=8", "torus", 256, 65536, 4096, 8, "multi", None),
    ("256^2 torus L=1200 R=8 (no tile of 8 fits)", "torus", 256, 65536, 1200, 8, "multi", None),
]


@pytest.mark.parametrize("case", ROUTES, ids=[c[0] for c in ROUTES])
def test_route_choices_on_an_h100(case):
    _, kind, size, nvars, L, R, route, B = case
    got, plan = wl.choose_route(kind, size, nvars, L, R, H100_OPTIN, H100_SMS)
    assert got == route
    if route == "resident":
        assert plan == wl.resident_plan(nvars, L, R, wl.WL_PARAM_BYTES, H100_OPTIN, H100_SMS)
    if route == "tiled":
        w = B + sum(wl.TILE_HALO)
        sites = w * w if kind == "torus" else w
        assert plan == (B, sites, wl.tiled_bytes(kind, B, L))
        assert plan[2] <= H100_OPTIN and B + sum(wl.TILE_HALO) <= size
    if route == "multi":
        assert plan is None and wl.tiled_plan(kind, size, nvars, L, R, H100_OPTIN, H100_SMS) is None


def test_resident_threshold_against_the_tiled_route():
    """The worldline's resident route takes at most RESIDENT_IDLE_SITES_TILED
    idle sites (where the tiled route is the faster beyond them), the
    ladder's, which has no tiled route, RESIDENT_IDLE_SITES."""
    assert wl.RESIDENT_IDLE_SITES_TILED < wl.RESIDENT_IDLE_SITES
    for m, R in ((24, 16), (32, 16), (32, 64), (40, 64)):  # between the two thresholds
        idle = m * m * (-(-R // H100_SMS) * H100_SMS - R) / H100_SMS
        assert wl.RESIDENT_IDLE_SITES_TILED < idle <= wl.RESIDENT_IDLE_SITES
        assert wl.resident_plan(m * m, 40, R, wl.WL_PARAM_BYTES, H100_OPTIN, H100_SMS) is not None
        assert wl.choose_route("torus", m, m * m, 40, R, H100_OPTIN, H100_SMS)[0] == "tiled"
    # a plane that fits a resident block but no tile has a side under 17 sites
    assert wl.choose_route("torus", 16, 256, 40, 1, H100_OPTIN, H100_SMS)[0] == "resident"
    assert wl.tiled_plan("torus", 16, 256, 40, 1, H100_OPTIN, H100_SMS) is None


def test_main_shape_plan():
    """The 256^2 x 8 x 40 torus: tiles of 32 (64 a side would not fit), a
    41^2 box (67,240 bytes of spins), 110,368
    bytes of shared memory, so two blocks an SM; 8 x 64 = 512 blocks."""
    B, sites, nbytes = wl.tiled_plan("torus", 256, 65536, 40, 8, H100_OPTIN, H100_SMS)
    assert (B, sites, nbytes) == (32, 41 * 41, 110368)
    assert 2 * (nbytes + 1024) <= H100_OPTIN + 1024
    assert wl.tiled_bytes("torus", 64, 40) > H100_OPTIN


def test_a_torus_too_small_for_a_box_is_not_tiled():
    """A box of the smallest tile (8 + 4 + 5 sites a side) must not hold a site twice."""
    for size in (8, 12, 16):
        assert wl.tiled_plan("torus", size, size * size, 40, 8, H100_OPTIN, H100_SMS) is None
    assert wl.tiled_plan("torus", 18, 324, 40, 8, H100_OPTIN, H100_SMS)[0] == 8
    assert wl.tiled_plan("ring", 16, 16, 40, 8, H100_OPTIN, H100_SMS) is None


def test_tiled_plan_reads_the_limit_it_is_given():
    need32 = wl.tiled_bytes("torus", 32, 40)
    assert wl.tiled_plan("torus", 256, 65536, 40, 8, need32, H100_SMS)[0] == 32
    assert wl.tiled_plan("torus", 256, 65536, 40, 8, need32 - 1, H100_SMS)[0] < 32
    need8 = wl.tiled_bytes("torus", 8, 40)
    assert wl.tiled_plan("torus", 256, 65536, 40, 8, need8, H100_SMS) == (8, 17 * 17, need8)
    assert wl.tiled_plan("torus", 256, 65536, 40, 8, need8 - 1, H100_SMS) is None
    assert wl.choose_route("torus", 256, 65536, 40, 8, need8 - 1, H100_SMS) == ("multi", None)


def test_tiled_plan_reads_the_sm_count_it_is_given():
    """512 blocks of tiles of 32 fill two waves of 132 SMs (two blocks each);
    on 1024 SMs the 2048 blocks of tiles of 16 fill one wave."""
    assert wl.tiled_plan("torus", 256, 65536, 40, 8, H100_OPTIN, 132)[0] == 32
    assert wl.tiled_plan("torus", 256, 65536, 40, 8, H100_OPTIN, 1024)[0] == 16


@pytest.mark.parametrize("kind,size,L,R", [("torus", 64, 60, 64), ("torus", 100, 40, 3), ("torus", 256, 200, 8),
                                          ("ring", 5000, 40, 2), ("ring", 60000, 4, 1), ("torus", 256, 4, 8)])
def test_tiled_plan_invariants(kind, size, L, R):
    nvars = size * size if kind == "torus" else size
    plan = wl.tiled_plan(kind, size, nvars, L, R, H100_OPTIN, H100_SMS)
    assert plan is not None
    B, sites, nbytes = plan
    assert B % wl.TILE_STEP == 0 and B >= wl.TILE_MIN and B + sum(wl.TILE_HALO) <= size
    assert sites <= 65535 and nbytes == wl.tiled_bytes(kind, B, L) <= H100_OPTIN


# --- a plain-torch emulation of the tile schedule ---------------------------


def _boxes(kind, side, B, halo):
    """Per tile: the global index of each box site, its color and rank, its
    neighbours' box indices (the box's site count for one outside the box,
    a zero line), the interior's box and global indices, and the interior's
    bond partners (y + 1, and x + 1 on a torus)."""
    lo, hi = halo
    torus = kind == "torus"
    out = []
    for x0 in range(0, side, B) if torus else [0]:
        for y0 in range(0, side, B):
            bx, by = (min(B, side - x0) if torus else 1), min(B, side - y0)
            hx, wx, wy = (lo, bx + lo + hi, by + lo + hi) if torus else (0, 1, by + lo + hi)
            u, v = (a.ravel() for a in np.meshgrid(np.arange(wx), np.arange(wy), indexing="ij"))
            gx, gy = ((x0 - hx + u) % side if torus else 0), (y0 - lo + v) % side
            gi = gx * side + gy if torus else gy
            color = (gx + gy) % 2

            def rank1(w, low, b):
                return np.where(w < low, low - w + 1, np.where(w >= low + b, w - low - b + 1, 0))

            rank = np.maximum(rank1(u, hx, bx), rank1(v, lo, by))
            n = wx * wy

            def nb(du, dv):
                uu, vv = u + du, v + dv
                return np.where((uu >= 0) & (uu < wx) & (vv >= 0) & (vv < wy), uu * wy + vv, n)

            nbrs = [nb(0, 1), nb(0, -1)] + ([nb(1, 0), nb(-1, 0)] if torus else [])
            inner = np.flatnonzero(rank == 0)
            partners = [nb(0, 1)[inner]] + ([nb(1, 0)[inner]] if torus else [])
            pad = np.array([n])  # the zero line's own neighbours
            out.append(dict(
                gi=torch.from_numpy(np.append(gi, 0)), color=np.append(color, -1), rank=np.append(rank, 99),
                nbrs=[torch.from_numpy(np.append(a, pad)) for a in nbrs], inner=torch.from_numpy(inner),
                inner_gi=torch.from_numpy(gi[inner]), partners=[torch.from_numpy(p) for p in partners]))
    return out


def tiled_emulation(s, seeds, tables, T, freq, nsamples, B, halo=wl.TILE_HALO, ranks=wl.TILE_RANKS):
    """``wl_sweeps``' result by the tile schedule, in plain torch."""
    R, nvars, L = s.shape
    side = tables.size if tables.kind == "torus" else nvars
    boxes = _boxes(tables.kind, side, B, halo)
    thr, cde, pb = tables.thr, tables.cde, int(tables.pb)
    tau = torch.arange(L)
    seed = seeds[:, None, None]
    state = s.to(torch.int32)
    stats = torch.zeros((R, 3), dtype=torch.int64)
    samples = torch.empty((R, nsamples, nvars), dtype=torch.int8)
    for t in range(T):
        new = torch.empty_like(state)
        for bx in boxes:
            x = state[:, bx["gi"]]
            x[:, -1] = 0  # the zero line outside the box
            pos1, pos2 = make_pos_mix(tau[None, :], bx["gi"][:, None], nvars)

            def draw(ctr):
                return lane_draw31(seed, pos1, pos2, ctr)

            def nsum(y):
                return sum(y[:, j] for j in bx["nbrs"])

            def update_set(p, color):
                return torch.from_numpy((bx["color"] == color) & (bx["rank"] <= ranks[p]))[None, :, None]

            d = wl.DRAWS_PER_SWEEP * t
            for p, (color, parity) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                ud = x.roll(-1, 2) + x.roll(1, 2)
                tv = thr[15 * (x > 0) + 3 * ((nsum(x) + 4) // 2) + (ud + 2) // 2]
                hit = (draw(d) <= tv) & update_set(p, color) & (tau % 2 == parity)
                x = torch.where(hit, -x, x)
                d += 1
            for color in (0, 1):
                active = ((x == x.roll(-1, 2)) & (draw(d) < pb)).to(torch.int32)
                de = cde[5 * (x > 0) + (nsum(x) + 4) // 2]
                log_u = torch.log((draw(d + 1).to(torch.float32) + 0.5) * LOG_SCALE)
                x = torch.where(wl.fk_flips(active, de, log_u) & update_set(4 + color, color), -x, x)
                d += 2
            inner = x[:, bx["inner"]]
            sb = inner * sum(x[:, p] for p in bx["partners"])
            stats += torch.stack([sb.sum((1, 2)), inner.sum((1, 2)), (inner == inner.roll(-1, 2)).sum((1, 2))], 1)
            if nsamples and (t + 1) % freq == 0 and (t + 1) // freq <= nsamples:
                samples[:, (t + 1) // freq - 1, bx["inner_gi"]] = inner[:, :, 0].to(torch.int8)
            new[:, bx["inner_gi"]] = inner
        state = new
    return state.to(torch.int8), stats, samples


def _case(kind, size, R, L, seed, beta=1.0, gamma=1.0, h=0.0):
    nvars = size * size if kind == "torus" else size
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.integers(0, 2, (R, nvars, L)).astype(np.int8) * 2 - 1)
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, R).astype(np.int32))
    return s, seeds, wl.make_tables((kind, size, -1.0), nvars, beta, gamma, h, L)


# name, kind, size, R, L_tau, T, tile, beta, gamma, h, freq, nsamples
SCHEDULES = [
    ("16^2 torus, 4x4 tiles", "torus", 16, 2, 8, 3, 4, 1.0, 1.0, 0.0, 0, 0),
    ("20^2 torus, tiles of 8 (the last partial)", "torus", 20, 3, 6, 3, 8, 1.0, 1.0, 0.2, 0, 0),
    ("64-ring in segments of 24 (the last partial)", "ring", 64, 2, 10, 4, 24, 1.0, 1.0, -0.1, 0, 0),
    ("66-ring in segments of 11 (odd origins)", "ring", 66, 4, 16, 4, 11, 1.0, 1.0, 0.0, 0, 0),
    ("frozen lines: 64-ring Gamma=0.05", "ring", 64, 4, 8, 3, 24, 2.0, 0.05, 0.2, 0, 0),
    ("L_tau=4: 16^2 torus, 4x4 tiles", "torus", 16, 2, 4, 3, 4, 0.4, 1.0, 0.1, 0, 0),
    ("sampling: 20^2 torus freq=2 nsamples=2", "torus", 20, 2, 8, 5, 8, 1.0, 1.0, 0.0, 2, 2),
]


@pytest.mark.parametrize("case", SCHEDULES, ids=[c[0] for c in SCHEDULES])
def test_tile_schedule_equals_the_plain_version(case):
    _, kind, size, R, L, T, B, beta, gamma, h, freq, ns = case
    s, seeds, tables = _case(kind, size, R, L, size + L + R, beta, gamma, h)
    want = wl.wl_sweeps_reference(s, seeds, tables, T, freq, ns)
    got = tiled_emulation(s, seeds, tables, T, freq, ns, B)
    for g, w, what in zip(got, want, ("states", "statistics", "samples")):
        assert torch.equal(g, w), f"{what} differ"
    assert not torch.equal(want[0], s), "no spin moved"
    if gamma < 0.1:
        frozen = float((want[0] == want[0][:, :, :1]).all(2).float().mean())
        assert frozen > 0.5, f"only {frozen} of the lines are constant in tau"


@pytest.mark.parametrize("kind,size,R,L,T,B", [("torus", 16, 2, 8, 3, 4), ("torus", 20, 2, 8, 3, 8),
                                                ("ring", 66, 16, 16, 4, 11)])
def test_a_halo_one_site_short_is_not_enough(kind, size, R, L, T, B):
    """The negative control: with a halo of (3, 4) sites, each phase clamped
    to the ranks that box can update, the interiors come out wrong. (A ring
    cut into tiles of even length needs one site less: the box's end sites
    then hold the color that no phase reads at that rank. Tiles of odd length
    need the full halo, as the torus does.)"""
    s, seeds, tables = _case(kind, size, R, L, size + L + R)
    want = wl.wl_sweeps_reference(s, seeds, tables, T)
    halo = tuple(x - 1 for x in wl.TILE_HALO)
    ranks = tuple(min(r, halo[0]) for r in wl.TILE_RANKS)
    got = tiled_emulation(s, seeds, tables, T, 0, 0, B, halo, ranks)
    assert not torch.equal(got[0], want[0])
    assert not torch.equal(got[1], want[1])


def test_tiled_counter_untouched_on_cpu():
    """The counters count kernel launches only: the plain version adds none."""
    counters = ("launches", "resident_launches", "tiled_launches")
    before = [getattr(wl.wl_sweeps, c) for c in counters]
    s, seeds, tables = _case("torus", 20, 2, 8, 0)
    assert wl.choose_route("torus", 20, 400, 8, 2, 0, H100_SMS) == ("multi", None)
    got = wl.wl_sweeps(s, seeds, tables, 2, 1, 2)
    want = wl.wl_sweeps_reference(s, seeds, tables, 2, 1, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [getattr(wl.wl_sweeps, c) for c in counters] == before


def test_wrapper_checks_still_raise():
    s, seeds, tables = _case("torus", 20, 2, 8, 1)
    for args, kw in [((s[:, :, :6], seeds, tables, 1), {}), ((s, seeds[:1], tables, 1), {}),
                     ((s, seeds, tables, 2), dict(freq=2, nsamples=2)), ((s, seeds.to(torch.int64), tables, 1), {})]:
        with pytest.raises(ValueError):
            wl.wl_sweeps(*args, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wl.wl_sweeps(s.to("meta"), seeds.to("meta"), tables._replace(thr=tables.thr.to("meta"),
                                                                       cde=tables.cde.to("meta")), 1)
