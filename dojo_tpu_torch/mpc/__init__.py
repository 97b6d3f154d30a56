"""Contact-MPC layer (counterpart of dojo_tpu/mpc): the runtime-gains
iLQR / MPC (rt path) and the quadruped trot controller, batched over
scenario lanes."""

from .ilqr import ILQRConfig, QuadCost, Trace, make_ilqr_rt, make_mpc_rt
from .trot import (
    TrotGains,
    TrotSpec,
    actuated_indices,
    make_trot_rt,
    trot_cost,
    trot_gains,
    trot_reference,
    trot_spring_params,
    trot_weight_schedule,
)
