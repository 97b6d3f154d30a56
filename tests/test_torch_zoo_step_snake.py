"""One float64 snake step (W=22, the kernels' 17..32 class) of the port
against dojo_tpu's jitted step (see tests/test_torch_zoo_step.py)."""

from test_torch_zoo_step import check_step


def test_snake_step_matches_reference():
    check_step("snake")
