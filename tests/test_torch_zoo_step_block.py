"""One float64 block step (W=70, the kernels' 33..72 class) of the port
against dojo_tpu's jitted step (see tests/test_torch_zoo_step.py)."""

from test_torch_zoo_step import check_step


def test_block_step_matches_reference():
    check_step("block")
