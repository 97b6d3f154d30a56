"""The batched one-step function and rollouts (counterpart of
dojo_tpu/simulate.py).

``make_step(topo, opts)`` returns step(params, state, u, fext, text, w_prev)
for a batch of lanes: state fields are (B, nb, k), u (B, nj, 6) padded per
joint (see residual.pad_inputs) or None.  ``make_simulate`` rolls it out
and records a time-major ``Trajectory``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import lie
from .contacts import signed_distances
from .core import BodyState, Params, SolverOptions, Topology
from .residual import make_context
from .solver import make_solver


@dataclasses.dataclass
class StepInfo:
    success: torch.Tensor
    iterations: torch.Tensor
    rvio: torch.Tensor
    bvio: torch.Tensor
    w: torch.Tensor  # full solver solution (velocities + impulses)
    rescued: torch.Tensor  # dense rescue pass finished this lane


def make_step(topo: Topology, opts: SolverOptions = SolverOptions(), device=None):
    """Returns step(params, state, u=None, fext=None, text=None, w_prev=None)
    -> (state', StepInfo); ``device=None`` means CUDA.

    w_prev (optional, (B, dim)): the previous step's StepInfo.w, which
    warm-starts the interior-point solve.  On a contact transition (a
    contact about to touch or lift off) the step restarts from the neutral
    cone init instead (SolverOptions.warm_onset_*)."""
    init_w, solve, _ = make_solver(topo, device=device)

    def step(params: Params, state: BodyState, u=None, fext=None, text=None,
             w_prev=None):
        ctx = make_context(topo, state, params, u, fext, text)
        h = params.timestep
        contact_reset = None
        if w_prev is not None and topo.nc and opts.warm_onset_margin >= 0.0:
            # activity predicted at the next candidate configuration, where
            # the contact rows are evaluated; any flip marks the whole step
            # as a transient
            state_pred = BodyState(
                x=lie.next_position(state.x, state.v, h),
                q=lie.next_orientation(state.q, state.w, h),
                v=state.v,
                w=state.w,
            )
            sdf = signed_distances(topo, params, state_pred)
            gam_prev = w_prev[:, topo.contact_off :].reshape(-1, topo.nc, topo.cw)[
                ..., topo.cw // 2
            ]
            will_touch = sdf < opts.warm_onset_margin
            was_active = gam_prev > opts.warm_onset_gamma
            transient = torch.any(will_touch != was_active, dim=-1, keepdim=True)
            contact_reset = transient.expand(-1, topo.nc)
        w0 = init_w(state.v, state.w, params, w_prev=w_prev,
                    warm_floor=opts.warm_floor, contact_reset=contact_reset)
        res = solve(w0, ctx, params, opts)
        bv = res.w[:, : 6 * topo.nb].reshape(-1, topo.nb, 6)
        v25, w25 = bv[..., :3], bv[..., 3:]
        new_state = BodyState(
            x=lie.next_position(state.x, v25, h),
            q=lie.next_orientation(state.q, w25, h),
            v=v25,
            w=w25,
        )
        info = StepInfo(
            success=res.success, iterations=res.iterations, rvio=res.rvio,
            bvio=res.bvio, w=res.w, rescued=res.rescued,
        )
        return new_state, info

    step.init_w = init_w
    return step


@dataclasses.dataclass
class Trajectory:
    """A recorded rollout, time-major: x, q, v, w (T, B, nb, k) are the
    state *before* each step; info holds each step's StepInfo stacked,
    fields (T, B, ...)."""

    x: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    info: StepInfo


def make_simulate(topo: Topology, opts: SolverOptions = SolverOptions(), device=None):
    """Returns simulate(params, state0, us=None, horizon=None, warm_start=False)
    -> (final state, Trajectory); ``device=None`` means CUDA.

    us: (T, B, nj, 6) padded inputs, or None with ``horizon`` steps of no
    input.  warm_start: each step warm-starts from the previous step's
    solution, the first from the cone-neutral init of state0 (so that it
    equals a cold solve up to the warm floor)."""
    step = make_step(topo, opts, device=device)

    def simulate(params: Params, state0: BodyState, us=None, horizon: int = None,
                 warm_start: bool = False):
        if us is None:
            if horizon is None:
                raise ValueError("simulate needs us or horizon")
            us = [None] * horizon
        w_prev = step.init_w(state0.v, state0.w, params) if warm_start else None
        state, pre, infos = state0, [], []
        for u in us:
            pre.append(state)
            state, info = step(params, state, u, w_prev=w_prev)
            if warm_start:
                w_prev = info.w
            infos.append(info)
        stack = lambda objs, f: torch.stack([getattr(o, f) for o in objs])
        info = StepInfo(**{f.name: stack(infos, f.name) for f in dataclasses.fields(StepInfo)})
        return state, Trajectory(*(stack(pre, f) for f in "xqvw"), info=info)

    return simulate
