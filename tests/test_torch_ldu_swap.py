"""The port's float32 block LU (ldu.blu_factor, the plain version of the
factorize kernels' block LU) against dojo_tpu.ldu.blu_factor, jitted alone.

Both swap rows arithmetically (row k becomes Tk + (Tp − Tk), row p becomes
Tp + (Tk − Tp), in every column) and round the Schur update M − mult·rowk
once: XLA makes a fused multiply-add of it, and the port forms it in
float64 and rounds once (ldu.schur_fma).  On the same float32 blocks the
pivot order is identical and LU and PS are equal bitwise.  (A float64
difference that lands exactly on a float32 tie rounds twice in the port and
could differ from the fused result by an ulp; none of these blocks meets
one, and the test would show it.)

Blocks (chip_smoke.swap_blocks), 12 real rows of W = 14 (pad rows identity):
- ``random``: rows of widely spread scales;
- ``dup``: row j is a power of two times row i, so that after row scaling
  the two rows are equal and their pivot cancels exactly, unless a swap has
  rounded one of them (without the arithmetic swap every such block's
  smallest pivot is the 1e-12 floor; with it, as in dojo_tpu, most are
  rounding noise);
- ``prop``: row j a random multiple of row i; ``comb``: row l a combination
  of rows i and j (pivots that cancel to rounding noise);
- the diagonal blocks of the quadruped KKT (tests/test_torch_ldu.py's
  fixture, float32) at each level of its factorization.
Wherever dojo_tpu's smallest |U_kk| is above the floor, the port's must be.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import swap_blocks
from test_torch_cuda import quadruped_kkt

from dojo_tpu import ldu as jldu
from dojo_tpu_torch import ldu

W, N_REAL = 14, 12
_jax_blu = jax.jit(jldu.blu_factor, static_argnums=1)


def _smallest_pivot(LU, n):
    return np.abs(np.diagonal(np.asarray(LU), axis1=-2, axis2=-1)[..., :n]).min(axis=-1)


def _check_matches(D, n):
    """Pivot order, LU and PS bitwise, and no pivot at the floor where
    dojo_tpu's is above it; returns (port, dojo_tpu) smallest pivots."""
    assert D.dtype == np.float32
    lu, ps = ldu.blu_factor(torch.as_tensor(D), n)
    jlu, jps = _jax_blu(jnp.asarray(D), n)
    jlu, jps = np.asarray(jlu), np.asarray(jps)
    assert jlu.dtype == np.float32 and lu.dtype == torch.float32
    np.testing.assert_array_equal(np.abs(ps.numpy()).argmax(-1), np.abs(jps).argmax(-1))
    np.testing.assert_array_equal(ps.numpy(), jps)
    np.testing.assert_array_equal(lu.numpy(), jlu)
    floor = ldu.pivot_floor(torch.float32)
    mine, ref = _smallest_pivot(lu.numpy(), n), _smallest_pivot(jlu, n)
    assert not np.any((mine <= floor) & (ref > floor))
    return mine, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["random", "dup", "prop", "comb"])
def test_blu_factor_matches_dojo_tpu_f32(kind, seed):
    mine, ref = _check_matches(swap_blocks(kind, seed, 64, W, N_REAL), N_REAL)
    if kind == "dup":  # the rows that cancel exactly unless a swap rounds them
        floor = ldu.pivot_floor(torch.float32)
        assert (ref > floor).sum() >= 16


@pytest.fixture(scope="module")
def quadruped_nodes():
    """The quadruped KKT's diagonal blocks as factored at their levels (a
    node's block takes no update after its level), float32, B=4."""
    sched, blocks, _ = quadruped_kkt(torch.float32)
    fb, _, _ = ldu.factorize(ldu.LduPlan(sched, "cpu"), blocks)
    return sched, fb[:, : sched.n_nodes].numpy()


@pytest.mark.parametrize("level", range(8))
def test_blu_factor_matches_dojo_tpu_f32_quadruped(quadruped_nodes, level):
    sched, D = quadruped_nodes
    lv = sched.levels[level]
    blocks = D[:, lv.nodes].reshape(-1, W, W)
    _check_matches(np.ascontiguousarray(blocks), int(lv.real_w))


@pytest.mark.parametrize("name,kw", [("quadruped", dict(timestep=0.05)), ("humanoid", {}),
                                     ("block", {})])
def test_lu_vs_plain_counts(name, kw):
    """chip_smoke.lu_vs_plain, the card's check of the factorize kernels'
    block LUs, on the plain factorization of chip_smoke.isolated_blocks
    (random blocks, none at the floor): no block differs; an LU entry
    moved by one ulp is one block at one ulp; a pivot set to the floor is
    one floored block."""
    import chip_smoke as C
    from dojo_tpu_torch import models
    from dojo_tpu_torch.graph import build_schedule

    sched = build_schedule(models.get_mechanism(name, device="cpu", **kw).topo)
    fb, lu, ps = ldu.factorize(ldu.LduPlan(sched, "cpu"), C.isolated_blocks(sched, "random", 0, 4,
                                                                           "cpu"))
    res = C.lu_vs_plain(sched, fb, lu, ps)
    assert res.pop("min_pivot") > ldu.pivot_floor(torch.float32)
    assert res == dict(blocks=4 * sched.n_nodes, differ=0, ulps=0, floored=0, at_floor=0)
    nd = int(sched.levels[0].nodes[0])
    moved = lu.clone()
    moved[1, nd, 0, 1] = torch.nextafter(moved[1, nd, 0, 1], torch.tensor(np.inf))
    assert C.lu_vs_plain(sched, fb, moved, ps)["differ"] == 1
    assert C.lu_vs_plain(sched, fb, moved, ps)["ulps"] == 1
    moved = lu.clone()
    moved[2, nd, 0, 0] = ldu.pivot_floor(torch.float32)
    res = C.lu_vs_plain(sched, fb, moved, ps)
    assert (res["differ"], res["floored"], res["at_floor"]) == (1, 1, 1)
