"""The shape gate of the port's resident worldline kernels (``ops/wl.resident_plan``),
and the swap features that ``ops/ladder.ladder_sweeps`` returns with its
state.

The gate decides by shape alone, from the opt-in shared memory per block and
the SM count that the caller passes in (227 KB, 232,448 bytes, and 132 SMs
on an H100), and from the sites that the idle SMs of a resident launch's
last wave could have swept (at most ``RESIDENT_IDLE_SITES``): the 256-site
chain and the tempering bench ladder go resident; the 256^2 torus and a 64^2
ladder at L_tau = 60 keep the multi-launch kernels, and so does a 48^2 torus
at 16 replicas, whose plane fits but which the multi-launch kernels sweep
faster. The features must equal a numpy count on the returned state exactly
(integers; tolerance: none). The resident kernels themselves run only on the
card, where ``chip_smoke.py`` holds them to the plain versions and to the
multi-launch kernels bit for bit; on the CPU every wrapper runs its plain
version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyisingmontecarlo_tpu_torch import rng as trng
from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
from pyisingmontecarlo_tpu_torch.ops import ladder, wl

torch.set_num_threads(1)

H100_OPTIN, H100_SMS = 232448, 132


def _ladder_bytes(kind, nvars):
    return ladder.param_bytes(kind, nvars)


# name, nvars, L_tau, R, parameter bytes, resident on an H100
SHAPES = [
    ("256-chain L=40 R=64", 256, 40, 64, wl.WL_PARAM_BYTES, True),
    ("bench ladder 12^2 L=60 R=64", 144, 60, 64, _ladder_bytes("torus", 144), True),
    ("24^2 torus L=40 R=16", 576, 40, 16, wl.WL_PARAM_BYTES, True),
    ("32^2 torus L=40 R=16", 1024, 40, 16, wl.WL_PARAM_BYTES, True),
    ("40^2 torus L=40 R=16 (fits, too many idle sites)", 1600, 40, 16, wl.WL_PARAM_BYTES, False),
    ("40^2 torus L=40 R=64", 1600, 40, 64, wl.WL_PARAM_BYTES, True),
    ("48^2 torus L=40 R=16 (fits, too many idle sites)", 2304, 40, 16, wl.WL_PARAM_BYTES, False),
    ("48^2 torus L=40 R=64 (fits, too many idle sites)", 2304, 40, 64, wl.WL_PARAM_BYTES, False),
    ("48^2 torus L=40 R=132 (one full wave)", 2304, 40, 132, wl.WL_PARAM_BYTES, True),
    ("32^2 torus L=40 R=264 (two full waves)", 1024, 40, 264, wl.WL_PARAM_BYTES, True),
    ("ring 8 L=4 R=1", 8, 4, 1, wl.WL_PARAM_BYTES, True),
    ("256^2 torus L=40 R=8", 65536, 40, 8, wl.WL_PARAM_BYTES, False),
    ("64^2 ladder L=60 R=64", 4096, 60, 64, _ladder_bytes("torus", 4096), False),
]


def _idle_sites(nvars, R, sms=H100_SMS):
    return nvars * (-(-R // sms) * sms - R) / sms


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_gate_choices_on_an_h100(shape):
    _, nvars, L, R, pbytes, resident = shape
    plan = wl.resident_plan(nvars, L, R, pbytes, H100_OPTIN, H100_SMS)
    assert (plan is not None) == resident
    if plan:
        tile, nbytes = plan
        assert nbytes == wl.resident_bytes(nvars, L, pbytes, tile) <= H100_OPTIN
        assert min(nvars // 2, -(-wl.RESIDENT_THREADS // L)) <= tile <= nvars // 2
        tiles = -(-(nvars // 2) // tile)
        assert tiles * tile - nvars // 2 < tiles, "tiles are not split evenly"
        assert _idle_sites(nvars, R) <= wl.RESIDENT_IDLE_SITES
    # a shape kept off the resident kernel leaves too many sites idle, or its
    # plane alone nearly fills the block
    if not resident:
        assert _idle_sites(nvars, R) > wl.RESIDENT_IDLE_SITES or nvars * L > H100_OPTIN - 16 * 1024


def test_gate_reads_the_limit_it_is_given():
    """The same shape at three limits: every line in one tile, tiles, none."""
    nvars, L, pbytes = 256, 40, wl.WL_PARAM_BYTES
    whole = wl.resident_bytes(nvars, L, pbytes, nvars // 2)
    assert wl.resident_plan(nvars, L, 64, pbytes, whole, H100_SMS) == (nvars // 2, whole)
    tile, nbytes = wl.resident_plan(nvars, L, 64, pbytes, whole - 1, H100_SMS)
    assert tile < nvars // 2 and nbytes <= whole - 1
    least = -(-wl.RESIDENT_THREADS // L)
    need = wl.resident_bytes(nvars, L, pbytes, least)
    assert wl.resident_plan(nvars, L, 64, pbytes, need, H100_SMS)[0] >= least
    assert wl.resident_plan(nvars, L, 64, pbytes, need - 1, H100_SMS) is None
    assert wl.resident_plan(nvars, L, 64, pbytes, 48 * 1024, H100_SMS) is not None
    assert wl.resident_plan(nvars, L, 64, pbytes, 16 * 1024, H100_SMS) is None


def test_gate_reads_the_sm_count_it_is_given():
    """64 replicas of a 40^2 torus fill about half of 132 SMs (824 idle
    sites: resident) but a quarter of 256 (1200: multi-launch), and one full
    wave of either leaves none idle."""
    nvars, L, pbytes = 1600, 40, wl.WL_PARAM_BYTES
    assert wl.resident_plan(nvars, L, 64, pbytes, H100_OPTIN, 132) is not None
    assert wl.resident_plan(nvars, L, 64, pbytes, H100_OPTIN, 256) is None
    for sms in (132, 256):
        assert wl.resident_plan(nvars, L, sms, pbytes, H100_OPTIN, sms) is not None


def test_idle_sites_threshold_can_be_lifted():
    """With no idle-sites threshold the gate admits what fits: the 48^2 torus
    at L_tau = 40 and 16 replicas, but never the 256^2 torus or the 64^2
    ladder at L_tau = 60."""
    nvars, L, pbytes = 2304, 40, wl.WL_PARAM_BYTES
    assert wl.resident_plan(nvars, L, 16, pbytes, H100_OPTIN, H100_SMS) is None
    tile, nbytes = wl.resident_plan(nvars, L, 16, pbytes, H100_OPTIN, H100_SMS, None)
    assert nbytes == wl.resident_bytes(nvars, L, pbytes, tile) <= H100_OPTIN
    assert wl.resident_plan(nvars, L, 16, pbytes, H100_OPTIN, H100_SMS, nvars) == (tile, nbytes)
    assert wl.resident_plan(65536, 40, 8, pbytes, H100_OPTIN, H100_SMS, None) is None
    assert wl.resident_plan(4096, 60, 64, _ladder_bytes("torus", 4096), H100_OPTIN, H100_SMS, None) is None


def test_longest_chain_the_gate_admits():
    """The 256-chain goes resident up to L_tau = 824 on an H100 (two lines a
    tile there), and no further."""
    admitted = [L for L in range(4, wl.MAX_LTAU + 1, 2)
                if wl.resident_plan(256, L, 64, wl.WL_PARAM_BYTES, H100_OPTIN, H100_SMS)]
    assert admitted == list(range(4, 826, 2))
    assert wl.resident_plan(256, 824, 64, wl.WL_PARAM_BYTES, H100_OPTIN, H100_SMS)[0] == 2


def _np_features(x, ea, eb):
    x = x.astype(np.int64)
    return (x[:, ea] * x[:, eb]).sum(2), x.sum((1, 2)), (x == np.roll(x, -1, 2)).sum((1, 2))


def _ladder_case(kind, size, R, L, seed):
    if kind == "ring":
        ea, eb = np.arange(size), (np.arange(size) + 1) % size
        nvars = size
    else:
        g = grid_2d_edges(size, size)
        ea, eb = np.array([a for (a, _), _ in g]), np.array([b for (_, b), _ in g])
        nvars = size * size
    rng = np.random.default_rng(seed)
    jv = rng.choice([-1.0, 1.0], (R, len(ea)))
    betas = np.geomspace(0.5, 2.0, R)
    planes = ladder.build_planes(kind, size, nvars, ea, eb, jv, betas, [1.0] * R, [0.1] * R, L)
    s = torch.from_numpy(rng.integers(0, 2, (R, nvars, L)).astype(np.int8) * 2 - 1)
    kd = trng.key_data_from_seeds(rng.integers(0, 2**64, R, dtype=np.uint64))
    seeds = []
    for _ in range(3):
        kd, sub = trng.split_all(kd)
        seeds.append(trng.seeds_from_key_data(sub))
    edges = (torch.from_numpy(ea.astype(np.int32)), torch.from_numpy(eb.astype(np.int32)))
    return s, torch.from_numpy(np.stack(seeds)), planes, edges, ea, eb


@pytest.mark.parametrize("kind,size,R,L", [("ring", 8, 3, 8), ("torus", 4, 2, 12), ("torus", 6, 5, 4)])
def test_ladder_features_equal_a_count_of_the_state(kind, size, R, L):
    s, seeds, planes, edges, ea, eb = _ladder_case(kind, size, R, L, size + R)
    for T in (0, 1, 3):
        x, feats = ladder.ladder_sweeps(s, seeds[:T], planes, T, edges)
        assert torch.equal(x, ladder.ladder_sweeps_reference(s, seeds[:T], planes, T, edges)[0])
        want = _np_features(x.numpy(), ea, eb)
        for got, w in zip(feats, want):
            np.testing.assert_array_equal(got.numpy(), w)
        for got, w in zip(ladder.swap_features(x, *edges), want):
            np.testing.assert_array_equal(got.numpy(), w)
        if T == 0:
            assert torch.equal(x, s)


def test_ladder_edge_checks():
    s, seeds, planes, edges, _, _ = _ladder_case("ring", 8, 2, 8, 0)
    with pytest.raises(ValueError, match="ea"):
        ladder.ladder_sweeps(s, seeds, planes, 3, (edges[0].long(), edges[1]))
    with pytest.raises(ValueError, match="eb"):
        ladder.ladder_sweeps(s, seeds, planes, 3, (edges[0], edges[1][:3]))


def test_resident_counters_untouched_on_cpu():
    """The counters count kernel launches only: the plain versions add none."""
    before = (wl.wl_sweeps.launches, wl.wl_sweeps.resident_launches, ladder.ladder_sweeps.launches,
              ladder.ladder_sweeps.resident_launches, ladder.ladder_sweeps.feature_launches)
    tables = wl.make_tables(("ring", 8, -1.0), 8, 1.0, 1.0, 0.0, 8)
    wl.wl_sweeps(torch.ones((1, 8, 8), dtype=torch.int8), torch.zeros(1, dtype=torch.int32), tables, 2, 1, 2)
    s, seeds, planes, edges, _, _ = _ladder_case("ring", 8, 2, 8, 1)
    ladder.ladder_sweeps(s, seeds, planes, 3, edges)
    after = (wl.wl_sweeps.launches, wl.wl_sweeps.resident_launches, ladder.ladder_sweeps.launches,
             ladder.ladder_sweeps.resident_launches, ladder.ladder_sweeps.feature_launches)
    assert after == before
