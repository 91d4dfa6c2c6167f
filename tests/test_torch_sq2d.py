"""The torch port's square-torus sweep (``ops/sq2d.py``) against the JAX
package's Pallas kernel: thresholds, the sweep with explicit random planes and
with hashed draws (bit for bit against ``run_steps_2d_testbits`` in interpret
mode and ``numpy_reference``), sampling mode, and the wrapper's checks.

On the CPU the wrapper runs the plain version; the CUDA kernel is held to that
version on the card by ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax
from jax.experimental.pallas import tpu as pltpu

from pyisingmontecarlo_tpu.ops import lanerng as jl
from pyisingmontecarlo_tpu.ops import sq2d_pallas as sp
from pyisingmontecarlo_tpu_torch import _kernels
from pyisingmontecarlo_tpu_torch.ops import sq2d
from test_pallas_interpret import numpy_reference

torch.set_num_threads(1)


def jax_thresholds(betas, j, h):
    """The JAX kernel's own [T, 10] table (f32 sigmoid, saturating cast)."""
    dE = jnp.asarray(sp._dE_values(j, h))
    f = jax.vmap(lambda b: (jax.nn.sigmoid(-b * dE) * 2147483647.0).astype(jnp.int32))
    return np.array(f(jnp.asarray(np.asarray(betas, np.float32))))


def _case(seed, L, T):
    rng = np.random.default_rng(seed)
    s0 = rng.integers(0, 2, (L, L)).astype(np.int8) * 2 - 1
    rb = rng.integers(0, 2**31, size=(2 * T, L, L // 2), dtype=np.int64).astype(np.int32)
    return s0, rb


def _testbits(s0, rb, betas, j, h):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(sp.run_steps_2d_testbits(jnp.asarray(s0[None]), rb, betas, j, h))[0]


def test_dE_values_match_jax():
    for j, h in ((-1.0, 0.0), (0.5, -0.3), (1.25, 0.7)):
        np.testing.assert_array_equal(sq2d.dE_values(j, h), sp._dE_values(j, h))


@pytest.mark.parametrize("j,h", [(-1.0, 0.0), (0.5, -0.3)])
def test_thresholds_close_to_jax(j, h):
    """Tolerance |delta| <= 512: torch.sigmoid and jax.nn.sigmoid differ by up
    to a few f32 ulps (128 each near 2^31) on a small share of inputs."""
    betas = np.concatenate([np.linspace(0.0, 3.0, 601), [5.0, 12.0, 40.0]]).astype(np.float32)
    got = sq2d.thresholds(betas, j, h)
    assert got.dtype == torch.int32 and got.shape == (len(betas), 10)
    diff = np.abs(got.numpy().astype(np.int64) - jax_thresholds(betas, j, h))
    assert diff.max() <= 512, diff.max()


def test_thresholds_saturate_and_underflow():
    """Exact: 2^31-1 where the f32 sigmoid saturates (beta=40, dE=-8), 0 where
    it underflows (dE=+8); torch's plain f32 -> int32 cast would give -2^31."""
    thr = sq2d.thresholds(np.array([40.0], np.float32), -1.0, 0.0)[0].numpy()
    dE = sq2d.dE_values(-1.0, 0.0)
    assert (thr[dE == -8.0] == 2**31 - 1).all()
    assert (thr[dE == 8.0] == 0).all()
    assert thr[dE == 0.0].tolist() == [2**30, 2**30]


@pytest.mark.parametrize(
    "seed,L,betas,j,h",
    [
        (0, 16, [0.2, 0.35, 0.5, 0.8, 1.2], -1.0, 0.0),
        (7, 16, [0.6, 0.6, 0.6], 0.5, -0.3),
    ],
)
def test_sweep_bit_exact_explicit_randoms(seed, L, betas, j, h):
    """Tolerance: none. The plain version with JAX's table and explicit random
    planes equals the Pallas testbits kernel and numpy_reference."""
    betas = np.asarray(betas, np.float32)
    s0, rb = _case(seed, L, len(betas))
    thr = torch.from_numpy(jax_thresholds(betas, j, h))
    got = sq2d.sweeps_2d(torch.from_numpy(s0[None]), torch.zeros(1, dtype=torch.int32), thr, 0,
                         rb=torch.from_numpy(rb))[0].numpy()
    np.testing.assert_array_equal(got, _testbits(s0, rb, betas, j, h))
    np.testing.assert_array_equal(got, numpy_reference(s0, rb, betas, j, h))


def test_frozen_and_forced_limits():
    """Draw 2^31-1: only a saturated threshold flips (none at beta=5 on the
    aligned ferromagnet). Draw 0: every site flips once per sweep."""
    L = 8
    s0 = torch.ones((1, L, L), dtype=torch.int8)
    thr = sq2d.thresholds(np.array([5.0], np.float32), -1.0, 0.0)
    seeds = torch.zeros(1, dtype=torch.int32)
    hi = torch.full((2, L, L // 2), 2**31 - 1, dtype=torch.int32)
    lo = torch.zeros((2, L, L // 2), dtype=torch.int32)
    assert (sq2d.sweeps_2d(s0, seeds, thr, 0, rb=hi) == 1).all()
    assert (sq2d.sweeps_2d(s0, seeds, thr, 0, rb=lo) == -1).all()


def test_sweep_bit_exact_lane_hash():
    """Tolerance: none. Hashed draws with ctr0 > 0 equal the JAX testbits kernel
    fed planes made with JAX's lane_draw31 under the randomness contract."""
    L, T, ctr0, seed, j, h = 16, 4, 11, -123456, 0.5, -0.3
    betas = np.array([0.3, 0.5, 0.7, 0.9], np.float32)
    s0, _ = _case(3, L, T)
    W = L // 2
    pos = (np.arange(L)[:, None] * W + np.arange(W)[None, :]).astype(np.int32)
    p1, p2 = jl.make_pos_mix(jnp.zeros((L, W), jnp.int32), jnp.asarray(pos), 0)
    seed_plane = jnp.full((L, W), seed, jnp.int32)
    planes = np.stack(
        [np.asarray(jl.lane_draw31(seed_plane, p1, p2, jnp.int32(2 * (ctr0 + t) + p)))
         for t in range(T) for p in (0, 1)]
    )
    thr = torch.from_numpy(jax_thresholds(betas, j, h))
    got = sq2d.sweeps_2d(torch.from_numpy(s0[None]), torch.tensor([seed], dtype=torch.int32), thr, ctr0)
    np.testing.assert_array_equal(got[0].numpy(), _testbits(s0, planes, betas, j, h))


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 2, (3, 8, 8)).astype(np.int8) * 2 - 1
    E, O = sq2d.pack_checkerboard(torch.from_numpy(s))
    jE, jO = sp.pack_checkerboard(jnp.asarray(s))
    np.testing.assert_array_equal(E.numpy(), np.asarray(jE))
    np.testing.assert_array_equal(O.numpy(), np.asarray(jO))
    np.testing.assert_array_equal(sq2d.unpack_checkerboard(E, O).numpy(), s)


def test_sampling_mode_stages_every_block():
    """freq=5 over 23 sweeps: slot i holds the state after 5(i+1) sweeps and
    the final state includes the 3 trailing sweeps (tolerance: none)."""
    L, R, ctr0 = 16, 3, 4
    s0 = torch.from_numpy(np.stack([_case(i, L, 1)[0] for i in range(R)]))
    seeds = torch.tensor([1, -2, 3], dtype=torch.int32)
    thr = sq2d.thresholds(np.linspace(0.2, 0.9, 23).astype(np.float32), -1.0, 0.1)
    fin, stack = sq2d.sweeps_2d(s0, seeds, thr, ctr0, samples=5)
    assert stack.shape == (R, 4, L, L) and stack.dtype == torch.int8
    cur = s0
    for i in range(4):
        cur = sq2d.sweeps_2d(cur, seeds, thr[5 * i : 5 * i + 5], ctr0 + 5 * i)
        assert torch.equal(cur, stack[:, i])
    assert torch.equal(sq2d.sweeps_2d(cur, seeds, thr[20:], ctr0 + 20), fin)
    # the input is left as it was
    assert torch.equal(s0, torch.from_numpy(np.stack([_case(i, L, 1)[0] for i in range(R)])))


def test_trajectory_independent_of_batch():
    L = 12
    s0 = torch.from_numpy(np.stack([_case(i, L, 1)[0] for i in range(3)]))
    seeds = torch.tensor([10, 20, 30], dtype=torch.int32)
    thr = sq2d.thresholds(np.full(9, 0.45, np.float32), -1.0, 0.0)
    batch = sq2d.sweeps_2d(s0, seeds, thr, 2)
    alone = sq2d.sweeps_2d(s0[1:2].contiguous(), seeds[1:2].contiguous(), thr, 2)
    assert torch.equal(batch[1:2], alone)


def _ok_args(L=8, R=2, T=3):
    return dict(
        s=torch.ones((R, L, L), dtype=torch.int8),
        seeds_i32=torch.zeros(R, dtype=torch.int32),
        thr=torch.zeros((T, 10), dtype=torch.int32),
        ctr0=0,
    )


@pytest.mark.parametrize(
    "change",
    [
        dict(s=torch.ones((2, 7, 7), dtype=torch.int8)),  # odd L
        dict(s=torch.ones((2, 2, 2), dtype=torch.int8)),  # L < 4
        dict(s=torch.ones((2, 8, 8), dtype=torch.int32)),  # dtype
        dict(s=torch.ones((2, 8, 16), dtype=torch.int8)[:, :, ::2]),  # not contiguous
        dict(seeds_i32=torch.zeros(3, dtype=torch.int32)),  # shape
        dict(thr=torch.zeros((3, 10), dtype=torch.int64)),  # dtype
        dict(ctr0=2**30 - 3),  # ctr0 + T reaches 2^30
        dict(rb=torch.zeros((6, 8, 8), dtype=torch.int32)),  # rb shape
        dict(samples=0),
        dict(s=torch.ones((2, 8, 8), dtype=torch.int8, device="meta")),  # tables on another device
    ],
)
def test_wrapper_rejects(change):
    args = _ok_args()
    args.update(change)
    with pytest.raises(ValueError):
        sq2d.sweeps_2d(**args)


def test_device_other_than_cpu_or_cuda_raises():
    args = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in _ok_args().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        sq2d.sweeps_2d(**args)


def test_cpu_runs_plain_version_without_launching():
    before = sq2d.sweeps_2d.launches
    args = _ok_args()
    assert torch.equal(sq2d.sweeps_2d(**args), sq2d.sweeps_2d_reference(**args))
    assert sq2d.sweeps_2d.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No hidden fallback: a missing compiler is an error, not a CPU run."""
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build(verbose=True)


def test_kernel_launch_error_raises_with_name_text_and_code(monkeypatch):
    """A C entry's nonzero return is raised by the one launcher, ``_kernels.call``,
    with the launch's name, the CUDA error's text and its code."""

    class FakeLib:
        @staticmethod
        def x_sweeps(*args):
            return 98

    monkeypatch.setattr(_kernels, "load", lambda: FakeLib())
    monkeypatch.setattr(_kernels, "error_string", lambda code: f"fake error {code}")
    with pytest.raises(RuntimeError, match=r"^x kernel launch failed: fake error 98 \(98\)$"):
        _kernels.call("x kernel", lambda lib: lib.x_sweeps(1, 2))
    _kernels.call("x kernel", lambda lib: 0)
