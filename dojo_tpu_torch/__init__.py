"""dojo_tpu_torch — the PyTorch/CUDA port of dojo_tpu.

Differentiable maximal-coordinate contact physics with a Mehrotra
interior-point solver over a graph-sparse block LDU, whose three kernels
(factorize, solve, matvec) are hand-written CUDA for Hopper (csrc/ldu.cu).
Imports torch and numpy only — never JAX, never dojo_tpu.  Entry points run
on CUDA unless given ``device="cpu"``.

    from dojo_tpu_torch import models
    from dojo_tpu_torch.core import SolverOptions
    from dojo_tpu_torch.simulate import make_step
    mech = models.get_mechanism("quadruped", timestep=0.05)
    state = models.initialize(mech, "quadruped")
    step = make_step(mech.topo, SolverOptions())
"""
