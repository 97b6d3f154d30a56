"""The port's differentiable step through contact (the sphere) and at the
cartpole's upright LQR point, against dojo_tpu's IFT at the port's
solution, float64 on the CPU (see tests/test_torch_diff_step.py for the
reference and the tolerances: Jacobians within 1e-8 of their scale).  The
cartpole's case (two port solves and a reference compile, ~30 s) is
marked slow to keep the tier-1 clock."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_diff_step import (
    CONTACT,
    SPHERE_V0,
    UPRIGHT,
    port_mechanism,
    port_solutions,
    reference_ift,
    rel_err,
    sphere_lanes,
)

from dojo_tpu import models as jmodels
from dojo_tpu_torch.core import SolverOptions
from dojo_tpu_torch.gradients import make_diff_step, minimal_jacobians
from dojo_tpu_torch.residual import make_context
from dojo_tpu_torch.solver import make_solver


def test_sphere_contact_jacobian_matches_reference():
    """∂(packed next state)/∂v0 through contact (the sphere 2 cm above the
    ground, moving at v0 in x) at rtol = btol = 1e-8: the jvp of
    make_diff_step against dojo_tpu's IFT at the port's solution (against
    central differences: the slow test below, and the card's phase diff)."""
    jm = jmodels.get_mechanism("sphere", timestep=0.01)
    mech = port_mechanism(jm, "sphere", timestep=0.01)
    topo, opts = mech.topo, SolverOptions(**CONTACT)
    s0 = sphere_lanes(mech)
    step = make_diff_step(topo, opts, device="cpu")

    def out(v0):
        vel = torch.cat([v0[:, None, None], s0.v[..., 1:]], dim=-1)
        return step(mech.params, dataclasses.replace(s0, v=vel)).pack()

    v0 = torch.as_tensor(SPHERE_V0)
    _, jv = torch.func.jvp(out, (v0,), (torch.ones_like(v0),))
    init_w, solve, _ = make_solver(topo, device="cpu")
    res = solve(init_w(s0.v, s0.w, mech.params), make_context(topo, s0, mech.params), mech.params,
                opts)
    z = s0.pack()
    for b in range(len(SPHERE_V0)):
        r = reference_ift(jm, "maximal", np.asarray(res.w[b]), float(res.mu[b]), z[b].numpy(),
                          np.zeros(topo.input_dim))
        assert rel_err(jv[b], r["x"][:, 3]) < 1e-8, b  # z = [x v q ω]: v0 is entry 3


@pytest.mark.slow
def test_cartpole_minimal_jacobians_at_upright():
    """The cartpole's (A, B) at upright (tests/test_control.py's LQR point)
    and two lanes near it, at rtol = btol = 1e-10."""
    jm = jmodels.get_mechanism("cartpole", timestep=0.01)
    mech = port_mechanism(jm, "cartpole", timestep=0.01)
    opts = SolverOptions(**UPRIGHT)
    y = np.array([[0.0, 0.0, 0.0, 0.0], [0.1, 0.05, -0.2, 0.3], [-0.2, 0.1, 0.05, -0.1]])
    u = np.zeros((3, mech.topo.input_dim))
    yt, ut = torch.as_tensor(y), torch.as_tensor(u)
    A, B = minimal_jacobians(mech.topo, opts, device="cpu")(mech.params, yt, ut)
    w, mu = port_solutions(mech, opts, yt, ut)
    for b in range(3):
        r = reference_ift(jm, "minimal", np.asarray(w[b]), float(mu[b]), y[b], u[b])
        assert rel_err(A[b], r["x"]) < 1e-8 and rel_err(B[b], r["u"]) < 1e-8, b
