"""IFT linearization of the minimal-coordinate step for trajectory
optimization (counterpart of dojo_tpu/gradients.py
make_rollout_linearize_minimal).

At the solver's solution w* and final complementarity target μ_f the
residual vanishes, r(w*; θ, μ_f) = 0, so the implicit function theorem gives

    ẇ* = −J⁻¹ ṙ,   J = ∂r/∂w + REG·I,

and A = ∂y′/∂y, B = ∂y′/∂u follow by pushing (ẏ, ẇ*) through the maximal →
minimal output map.  ``linearize`` assembles J's blocks and factorizes them
once per knot, and solves all ny + nu tangent columns of the knot against
that one factorization: on a CUDA tensor the LDU kernels read each knot's
factors in place for its columns (``rhs_per_fact``), with no copy per
column.

Everything is batched over a leading lane axis: a lane is a scenario (the
rollout's ``step_w``) or a knot (``linearize``).  Parameters are shared.
"""

from __future__ import annotations

import torch

from . import ldu_cuda as L
from . import lie
from .blocks import Assembler, local_jacobian
from .core import REG, BodyState, Params, SolverOptions, Topology, resolve_device
from .graph import build_schedule
from .minimal import maximal_to_minimal, minimal_to_maximal
from .residual import Residual, make_context, pad_inputs
from .solver import make_solver


def to_maximal(topo: Topology, params: Params, y: torch.Tensor) -> BodyState:
    """minimal_to_maximal over a leading lane axis: y (B, ny) → (B, nb, k)."""
    def one(y1):
        s = minimal_to_maximal(topo, params, y1)
        return s.x, s.q, s.v, s.w

    return BodyState(*torch.func.vmap(one)(y))


def to_minimal(topo: Topology, params: Params, state: BodyState) -> torch.Tensor:
    """maximal_to_minimal over a leading lane axis: (B, nb, k) → y (B, ny)."""
    return torch.func.vmap(
        lambda x, q, v, w: maximal_to_minimal(topo, params, BodyState(x, q, v, w))
    )(state.x, state.q, state.v, state.w)


def next_state(topo: Topology, state: BodyState, w: torch.Tensor, h) -> BodyState:
    """The configuration one step on, from the solution's body velocities."""
    bv = w[..., : 6 * topo.nb].reshape(*w.shape[:-1], topo.nb, 6)
    v25, w25 = bv[..., :3], bv[..., 3:]
    return BodyState(
        x=lie.next_position(state.x, v25, h),
        q=lie.next_orientation(state.q, w25, h),
        v=v25,
        w=w25,
    )


def make_rollout_linearize_minimal(topo: Topology, opts: SolverOptions = SolverOptions(),
                                   linsolve: str = "auto", device=None):
    """(step_w, linearize, w_seed) sharing one contact solve per knot between
    the rollout and the linearization; ``device=None`` means CUDA.

      step_w(params, y, u_packed, w_prev=None, stats=None) → (y2, w, mu, success)
        y (B, ny), u_packed (B, nu), w_prev (B, dim) warm-starts the solve
        (its floors only: no warm-onset re-centering, as in the reference).
        ``stats``, a dict, accumulates the solve's counts as device
        tensors: solves, lanes, Newton iterations (summed over lanes) and
        lanes finished by the dense rescue.
      linearize(params, y, u_packed, w, mu) → (A (K, ny, ny), B (K, ny, nu))
        for K knots at their solutions w (K, dim), mu (K,).
      w_seed(params, y) → the cone-neutral solver init (B, dim).
    """
    device = resolve_device(device)
    init_w, solve, _ = make_solver(topo, device=device, linsolve=linsolve)
    res_fn = Residual(topo, device)
    ny, nu = topo.minimal_dim, topo.input_dim
    sched = build_schedule(topo) if linsolve == "auto" else None
    if sched is not None:
        assemble = Assembler(topo, sched, device)
        ds = L.DeviceSchedule(sched, device)

    def step_w(params: Params, y, u_packed, w_prev=None, stats=None):
        state = to_maximal(topo, params, y)
        ctx = make_context(topo, state, params, pad_inputs(topo, u_packed))
        w0 = init_w(state.v, state.w, params, w_prev=w_prev, warm_floor=opts.warm_floor)
        res = solve(w0, ctx, params, opts)
        if stats is not None:
            for key, val in (("solves", 1), ("lanes", y.shape[0]),
                             ("iterations", res.iterations.sum()),
                             ("rescued", res.rescued.sum())):
                stats[key] = stats.get(key, 0) + val
        y2 = to_minimal(topo, params, next_state(topo, state, res.w, params.timestep))
        return y2, res.w, res.mu, res.success

    def linearize(params: Params, y, u_packed, w, mu):
        K, D = w.shape
        C = ny + nu
        state = to_maximal(topo, params, y)
        ctx = make_context(topo, state, params, pad_inputs(topo, u_packed))
        if sched is not None:
            # one assembly and factorization per knot, shared by its C
            # tangent columns; one refinement sweep recovers the float32
            # digits the block elimination loses
            blocks = assemble(w, ctx, params, mu).contiguous()
            fact = L.factorize(ds, blocks)

            def lin_solve(rhs):  # (K, C, D)
                b = L.flat_to_nodes(ds.plan, rhs).reshape(K * C, *ds.plan.vec_idx.shape)
                x = L.solve_refine(ds, blocks, fact, b.contiguous(), 1, rhs_per_fact=C)
                return L.nodes_to_flat(ds.plan, x, D).reshape(K, C, D)
        else:
            J = local_jacobian(lambda v: res_fn(v, ctx, params, mu), w, chunk_size=64)
            J = J + REG * torch.eye(D, dtype=w.dtype, device=w.device)
            LU, piv = torch.linalg.lu_factor(J)

            def lin_solve(rhs):
                return torch.linalg.lu_solve(LU, piv, rhs.mT).mT

        def r_of(y_, u_):
            st = to_maximal(topo, params, y_)
            return res_fn(w, make_context(topo, st, params, pad_inputs(topo, u_)), params, mu)

        def out_fn(y_, w_):
            st = to_maximal(topo, params, y_)
            return to_minimal(topo, params, next_state(topo, st, w_, params.timestep))

        # tangent columns (K, C, ·): the ny state directions, then the nu
        # input directions, the same for every knot
        eye = torch.eye(C, dtype=w.dtype, device=w.device).expand(K, C, C)
        dy, du = eye[..., :ny], eye[..., ny:]
        rdot = torch.func.vmap(lambda a, b: torch.func.jvp(r_of, (y, u_packed), (a, b))[1],
                               in_dims=1, out_dims=1)(dy, du)
        dw = -lin_solve(rdot)
        dy2 = torch.func.vmap(lambda a, b: torch.func.jvp(out_fn, (y, w), (a, b))[1],
                              in_dims=1, out_dims=1)(dy, dw)  # (K, C, ny)
        return dy2[:, :ny].mT, dy2[:, ny:].mT

    def w_seed(params: Params, y):
        """Cone-neutral solver init for the first knot of a rollout."""
        state = to_maximal(topo, params, y)
        return init_w(state.v, state.w, params)

    return step_w, linearize, w_seed
