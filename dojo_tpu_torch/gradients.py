"""Differentiable dynamics: implicit-function-theorem gradients through the
contact solver (counterpart of dojo_tpu/gradients.py).

At the solver's solution w* and final complementarity target μ_f the
residual vanishes, r(w*; θ, μ_f) = 0, so the implicit function theorem gives

    ẇ* = −J⁻¹ ṙ,   J = ∂r/∂w + REG·I,

the gradients of the relaxed problem, as the reference takes them.
``make_diff_step`` packages this as a ``torch.autograd.Function`` on the
fixed point w*(θ): its forward is the solver (no autograd graph), its jvp
solves J ẇ = −ṙ and its backward Jᵀλ = ḡ with one dense LU of J, so
``backward`` and ``torch.func.jvp`` reach params, state and u.
``torch.autograd.forward_ad`` cannot: the solver's own KKT assembly is
forward-mode AD, which does not nest inside a dual level.  Everything
downstream of w* (the next state, the maximal → minimal map, a loss) is
plain autograd.

``minimal_jacobians`` / ``maximal_jacobians`` push every identity column
through one solve and one LU of J per lane.  ``linearize`` of
``make_rollout_linearize_minimal`` assembles J's blocks and factorizes them
once per knot, and solves all ny + nu tangent columns of the knot against
that one factorization: on a CUDA tensor the LDU kernels read each knot's
factors in place for its columns (``rhs_per_fact``), with no copy per
column.

Everything is batched over a leading lane axis: a lane is a scenario (the
rollout's ``step_w``, the diff step) or a knot (``linearize``).  Parameters
are shared by the lanes, so a gradient into them sums over lanes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

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


def dense_factor(res_fn, w, ctx, params: Params, mu):
    """(LU, pivots) of J = ∂r/∂w + REG·I per lane, (B, D, D): the matrix the
    reference's IFT solves with (jacfwd, then a pivoted LU solve)."""
    J = local_jacobian(lambda v: res_fn(v, ctx, params, mu), w)
    return torch.linalg.lu_factor(J + REG * torch.eye(w.shape[-1], dtype=w.dtype,
                                                      device=w.device))


def ift_columns(r_of, out_fn, x, u, w, lin_solve):
    """(∂out/∂x (B, m, nx), ∂out/∂u (B, m, nu)) at the solution w (B, D):
    every identity column of (x, u) through ṙ = jvp of r_of(x, u), then
    ẇ = −lin_solve(ṙ), then jvp of out_fn(x, w).  lin_solve takes the
    columns of all lanes at once, (B, C, D)."""
    B, nx = x.shape
    C = nx + u.shape[-1]
    eye = torch.eye(C, dtype=w.dtype, device=w.device).expand(B, C, C)
    dx, du = eye[..., :nx], eye[..., nx:]
    rdot = torch.func.vmap(lambda a, b: torch.func.jvp(r_of, (x, u), (a, b))[1],
                           in_dims=1, out_dims=1)(dx, du)
    dw = -lin_solve(rdot)
    dout = torch.func.vmap(lambda a, b: torch.func.jvp(out_fn, (x, w), (a, b))[1],
                           in_dims=1, out_dims=1)(dx, dw)  # (B, C, m)
    return dout[:, :nx].mT, dout[:, nx:].mT


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
            LU, piv = dense_factor(res_fn, w, ctx, params, mu)

            def lin_solve(rhs):
                return torch.linalg.lu_solve(LU, piv, rhs.mT).mT

        def r_of(y_, u_):
            st = to_maximal(topo, params, y_)
            return res_fn(w, make_context(topo, st, params, pad_inputs(topo, u_)), params, mu)

        def out_fn(y_, w_):
            st = to_maximal(topo, params, y_)
            return to_minimal(topo, params, next_state(topo, st, w_, params.timestep))

        # tangent columns: the ny state directions, then the nu input
        # directions, the same for every knot
        return ift_columns(r_of, out_fn, y, u_packed, w, lin_solve)

    def w_seed(params: Params, y):
        """Cone-neutral solver init for the first knot of a rollout."""
        state = to_maximal(topo, params, y)
        return init_w(state.v, state.w, params)

    return step_w, linearize, w_seed


class _Ift:
    """What the fixed point w*(θ) of one topology needs: the cold solve, the
    residual and the (params, state, u) pytree of the Function's inputs."""

    def __init__(self, topo: Topology, opts: SolverOptions, device):
        self.topo, self.opts = topo, opts
        self.init_w, self.solve, _ = make_solver(topo, device=device)
        self.res_fn = Residual(topo, device)

    def solve_cold(self, params: Params, state: BodyState, u):
        """The solver's result per lane from the cone-neutral init, as
        make_step's step without a warm start; builds no autograd graph."""
        with torch.no_grad():
            ctx = make_context(self.topo, state, params, u)
            return self.solve(self.init_w(state.v, state.w, params), ctx, params, self.opts)

    def r_of(self, w, mu):
        """θ = (params, state, u) ↦ r(w; θ, μ) at a fixed (w, μ)."""
        return lambda p, s, u: self.res_fn(w, make_context(self.topo, s, p, u), p, mu)

    def factor(self, theta, w, mu):
        params, state, u = theta
        with torch.no_grad():
            return dense_factor(self.res_fn, w, make_context(self.topo, state, params, u),
                                params, mu)

    def jacobians(self, params: Params, x, u_packed, to_state, from_state):
        """(∂x'/∂x, ∂x'/∂u, x') per lane for x' = from_state(next state) and
        state = to_state(x): one solve and one dense LU of J per lane, shared
        by every identity column."""
        topo, h = self.topo, params.timestep
        with torch.no_grad():
            state, u = to_state(x), pad_inputs(topo, u_packed)
            res = self.solve_cold(params, state, u)
            w, mu = res.w, res.mu
            LU, piv = self.factor((params, state, u), w, mu)

            def r_of(x_, u_):
                return self.r_of(w, mu)(params, to_state(x_), pad_inputs(topo, u_))

            def out_fn(x_, w_):
                return from_state(next_state(topo, to_state(x_), w_, h))

            fx, fu = ift_columns(r_of, out_fn, x, u_packed, w,
                                 lambda rhs: torch.linalg.lu_solve(LU, piv, rhs.mT).mT)
            return fx, fu, from_state(next_state(topo, state, w, h))


class _FixedPoint(torch.autograd.Function):
    """(w*, μ_f, success, rescued, iterations) = the solver's solution and
    status for the pytree θ = (params, state, u), given flat (apply sends
    gradients only to tensors passed directly); only w* is differentiable.
    Tangents and cotangents go through the IFT at (w*, μ_f) with one dense
    LU of J + REG·I a call."""

    @staticmethod
    def forward(ift, spec, *leaves):
        params, state, u = pytree.tree_unflatten(list(leaves), spec)
        res = ift.solve_cold(params, state, u)
        return res.w, res.mu, res.success, res.rescued, res.iterations

    @staticmethod
    def setup_context(ctx, inputs, output):
        ift, spec, *leaves = inputs
        w, mu, *status = output
        ctx.mark_non_differentiable(mu, *status)
        ctx.ift, ctx.spec = ift, spec
        ctx.save_for_backward(*leaves, w, mu)
        ctx.save_for_forward(*leaves, w, mu)

    @staticmethod
    def jvp(ctx, _ift, _spec, *dots):
        *leaves, w, mu = ctx.saved_tensors
        theta = pytree.tree_unflatten(leaves, ctx.spec)
        dtheta = pytree.tree_unflatten(
            [torch.zeros_like(a) if d is None else d for a, d in zip(leaves, dots)], ctx.spec)
        rdot = torch.func.jvp(ctx.ift.r_of(w, mu), tuple(theta), tuple(dtheta))[1]
        LU, piv = ctx.ift.factor(theta, w, mu)
        wdot = -torch.linalg.lu_solve(LU, piv, rdot[..., None])[..., 0]
        return wdot, None, None, None, None

    @staticmethod
    def backward(ctx, gw, *_):
        *leaves, w, mu = ctx.saved_tensors
        theta = pytree.tree_unflatten(leaves, ctx.spec)
        LU, piv = ctx.ift.factor(theta, w, mu)
        # λ = J⁻ᵀ ḡ with the jvp's LU, then −λ pulled back through r
        lam = torch.linalg.lu_solve(LU, piv, gw[..., None], adjoint=True)[..., 0]
        _, pull = torch.func.vjp(ctx.ift.r_of(w, mu), *theta)
        grads = pytree.tree_leaves(pull(-lam))
        return (None, None, *(g if need else None
                              for g, need in zip(grads, ctx.needs_input_grad[2:])))


def make_diff_step(topo: Topology, opts: SolverOptions = SolverOptions(), device=None):
    """Returns a differentiable step(params, state, u=None, stats=None) →
    BodyState; ``device=None`` means CUDA.

    state (B, nb, k), u (B, nj, 6) padded per joint (residual.pad_inputs)
    or None for no input.  Each lane is solved cold (the cone-neutral init),
    as make_step's step without w_prev.  Gradients flow into params
    (system identification), state and u (dynamics Jacobians), by
    ``backward`` and by ``torch.func.jvp``.  Do not vmap it: the solver
    syncs with the host.  ``stats``, a dict, accumulates the solve's counts
    as integers: solves, lanes, Newton iterations (summed over lanes),
    lanes finished by the dense rescue and lanes that did not converge
    (whose next state is no solution's and whose gradient no derivative).
    """
    ift = _Ift(topo, opts, resolve_device(device))

    def step(params: Params, state: BodyState, u=None, stats=None) -> BodyState:
        if u is None:
            u = state.x.new_zeros(*state.x.shape[:-2], topo.nj, 6)
        leaves, spec = pytree.tree_flatten((params, state, u))
        w, _, success, rescued, iterations = _FixedPoint.apply(ift, spec, *leaves)
        if stats is not None:
            for key, val in (("solves", 1), ("lanes", w.shape[0]),
                             ("iterations", int(iterations.sum())),
                             ("rescued", int(rescued.sum())), ("failed", int((~success).sum()))):
                stats[key] = stats.get(key, 0) + val
        return next_state(topo, state, w, params.timestep)

    return step


def make_diff_step_minimal(topo: Topology, opts: SolverOptions = SolverOptions(), device=None):
    """Differentiable minimal-coordinate dynamics y' = f(params, y, u_packed),
    y (B, ny), u_packed (B, nu); ``stats`` as make_diff_step's."""
    step = make_diff_step(topo, opts, device)

    def step_min(params: Params, y, u_packed, stats=None):
        state = step(params, to_maximal(topo, params, y), pad_inputs(topo, u_packed), stats)
        return to_minimal(topo, params, state)

    return step_min


def minimal_jacobians(topo: Topology, opts: SolverOptions = SolverOptions(), device=None):
    """jac(params, y (B, ny), u_packed (B, nu)) → (∂y'/∂y (B, ny, ny),
    ∂y'/∂u (B, ny, nu)): what forward-mode Jacobians of the minimal diff step
    give, from one solve and one LU of J per lane."""
    ift = _Ift(topo, opts, resolve_device(device))

    def jac(params: Params, y, u_packed):
        fy, fu, _ = ift.jacobians(params, y, u_packed, lambda y_: to_maximal(topo, params, y_),
                                  lambda s: to_minimal(topo, params, s))
        return fy, fu

    return jac


def _maximal_jacobians(topo: Topology, opts: SolverOptions, device):
    ift = _Ift(topo, opts, resolve_device(device))
    return lambda params, z, u_packed: ift.jacobians(
        params, z, u_packed, lambda z_: BodyState.unpack(z_, topo.nb), BodyState.pack)


def maximal_jacobians(topo: Topology, opts: SolverOptions = SolverOptions(), device=None):
    """jac(params, z (B, 13·nb), u_packed (B, nu)) → (∂z'/∂z, ∂z'/∂u) on
    packed maximal states z = [x v q ω]·nb, 13·nb in and out."""
    jac13 = _maximal_jacobians(topo, opts, device)
    return lambda params, z, u_packed: jac13(params, z, u_packed)[:2]


def attitude_jacobian(z, nb: int):
    """G(z) (..., 13·nb, 12·nb), block diagonal, mapping attitude-tangent
    states to packed maximal states: identity on the x, v and ω blocks,
    L(q)·Vᵀ on each quaternion block."""
    q = BodyState.unpack(z, nb).q
    G = z.new_zeros(*z.shape[:-1], 13 * nb, 12 * nb)
    eye6 = torch.eye(6, dtype=z.dtype, device=z.device)
    eye3 = torch.eye(3, dtype=z.dtype, device=z.device)
    for b in range(nb):
        r, c = 13 * b, 12 * b
        G[..., r : r + 6, c : c + 6] = eye6  # x, v
        G[..., r + 6 : r + 10, c + 6 : c + 9] = lie.Lmat(q[..., b, :])[..., 1:]
        G[..., r + 10 : r + 13, c + 9 : c + 12] = eye3
    return G


def maximal_jacobians_attjac(topo: Topology, opts: SolverOptions = SolverOptions(),
                             device=None):
    """(∂z'/∂z, ∂z'/∂u) in the 12·nb attitude-tangent form:
    G(z')ᵀ·(∂z'/∂z)·G(z) and G(z')ᵀ·(∂z'/∂u), per lane."""
    jac13 = _maximal_jacobians(topo, opts, device)

    def jac(params: Params, z, u_packed):
        fz, fu, z2 = jac13(params, z, u_packed)
        g_in, g_out = attitude_jacobian(z, topo.nb), attitude_jacobian(z2, topo.nb)
        return g_out.mT @ fz @ g_in, g_out.mT @ fu

    return jac


def finite_difference_jacobian(f, x, eps=1e-6):
    """Central-difference Jacobian of ``f`` at ``x`` on the host: columns
    (f(x + εeᵢ) − f(x − εeᵢ)) / 2ε as an (out_dim, x.size) float64 array;
    calls f 2·x.size times with numpy arrays of x's shape."""
    x = np.asarray(x, dtype=np.float64)
    cols = []
    for i in range(x.size):
        dx = np.zeros_like(x)
        dx.flat[i] = eps
        fp = np.asarray(f(x + dx), dtype=np.float64)
        fm = np.asarray(f(x - dx), dtype=np.float64)
        cols.append((fp - fm) / (2 * eps))
    return np.stack(cols, axis=-1)
