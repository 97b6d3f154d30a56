"""The behaviour oracles of tests/test_behaviors.py that the new models
meet, run on the port's plain path (the CPU, float64): fourbar's loop
closure and atlas's drop.  Marked slow: each is hundreds of float64 solves
on the CPU (atlas's drop: 100 steps of a 436-dim KKT, tens of seconds a
step)."""

import numpy as np
import pytest
import torch

from dojo_tpu_torch import models
from dojo_tpu_torch.contacts import signed_distances
from dojo_tpu_torch.core import SolverOptions
from dojo_tpu_torch.minimal import _joint_slices, maximal_to_minimal
from dojo_tpu_torch.simulate import make_step


@pytest.mark.slow
def test_fourbar_loop_closure():
    """Loop coordinates stay consistent over a driven 2.5 s rollout: the
    parallelogram relations to 1e-5, every step converged (as
    tests/test_behaviors.py holds dojo_tpu)."""
    mech = models.get_mechanism("fourbar", parse_dampers=False, device="cpu")
    state = models.initialize(mech, "fourbar", inner_angle=0.25)
    step = make_step(mech.topo, SolverOptions(rtol=1e-8, btol=1e-8), device="cpu")
    rng = np.random.default_rng(1)
    slices, _ = _joint_slices(mech.topo)
    idx = {n: slices[j][0] for n, j in mech.joint_index.items()}
    lanes = lambda s: type(s)(**{f: getattr(s, f)[None] for f in "xqvw"})
    state = lanes(state)
    u = torch.zeros(1, mech.topo.nj, 6, dtype=torch.float64)
    worst = 0.0
    for k in range(250):
        u.zero_()  # drive the two base cranks with random torque
        u[0, mech.joint_index["jointb1"], 3] = 1.0 * rng.random()
        u[0, mech.joint_index["joint12"], 3] = -1.0 * rng.random()
        state, info = step(mech.params, state, u)
        assert bool(info.success.all()), k
        one = type(state)(**{f: getattr(state, f)[0] for f in "xqvw"})
        y = maximal_to_minimal(mech.topo, mech.params, one).numpy()
        th = {n: y[i] for n, i in idx.items()}
        worst = max(worst, abs(th["joint24"] - th["joint34"]), abs(th["joint24"] + th["joint12"]),
                    abs(th["joint24"] - (th["jointb1"] - th["jointb3"])))
    assert worst < 1e-5, worst
    assert all(bool(torch.isfinite(getattr(state, f)).all()) for f in "xqvw")


@pytest.mark.slow
def test_atlas_drop_balance():
    """Atlas with joint springs and dampers, dropped from 2 cm above its
    standing height, over 1 s (100 steps): success over 0.9, no contact
    deeper than 5e-4, the root not collapsed by 0.25, finite states (the
    gates of tests/test_behaviors.py's dojo_tpu test)."""
    mech = models.get_mechanism("atlas", springs=1000.0, dampers=100.0, parse_springs=False,
                                parse_dampers=False, device="cpu")
    state = models.initialize(mech, "atlas", body_position=(0, 0, 0.9385 + 0.02))
    state = type(state)(**{f: getattr(state, f)[None] for f in "xqvw"})
    z0 = float(state.x[0, 0, 2])
    n = max(10, int(round(1.0 / mech.timestep)))
    step = make_step(mech.topo, SolverOptions(rtol=1e-6, btol=1e-4, max_iter=30), device="cpu")
    ok, min_sdf = [], np.inf
    for _ in range(n):
        state, info = step(mech.params, state)
        ok.append(bool(info.success[0]))
        min_sdf = min(min_sdf, float(signed_distances(mech.topo, mech.params, state).min()))
    assert np.mean(ok) > 0.9, np.mean(ok)
    assert min_sdf > -5e-4, min_sdf
    z = float(state.x[0, 0, 2])
    assert z > z0 - 0.25, (z, z0)
    assert all(bool(torch.isfinite(getattr(state, f)).all()) for f in "xqvw")
