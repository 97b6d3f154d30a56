"""One float64 cartpole step of the port against dojo_tpu's jitted step (see
tests/test_torch_zoo_step.py)."""

from test_torch_zoo_step import check_step


def test_cartpole_step_matches_reference():
    check_step("cartpole")
