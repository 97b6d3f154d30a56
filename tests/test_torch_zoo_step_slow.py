"""One float64 step of the port against dojo_tpu's jitted step for the zoo
models the tier-1 files leave out (see tests/test_torch_zoo_step.py).  Marked
slow: eighteen XLA compiles of dojo_tpu's solve, the larger models' minutes
each on a CPU host (atlas's ~20 minutes)."""

import pytest
from test_torch_zoo_step import check_step


@pytest.mark.slow
@pytest.mark.parametrize("name", ["npendulum", "sphere", "hopper", "halfcheetah", "walker", "ant",
                                  "humanoid"])
def test_zoo_step_matches_reference(name):
    check_step(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["dzhanibekov", "tippetop", "raiberthopper", "block2d",
                                  "quadrotor", "uuv", "panda", "youbot", "exoskeleton", "atlas",
                                  "fourbar"])
def test_more_zoo_steps_match_reference(name):
    """The eleven models dojo_tpu's zoo has beyond bench_zoo's (fourbar on
    the dense path of both packages)."""
    check_step(name)
