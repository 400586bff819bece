"""`mode=test` of the port's CLI against the JAX package's with
test.eval_on_cubes: the v*6 cube faces of every target view scored (the
reference's protocol), depth as cube z-depth with the top face excluded.
The same scenes, weights and bars as tests/test_torch_eval.py, in a file
of its own so that the two runs spread over the test workers.
"""

import pytest

from test_torch_eval import compare_outputs, run_both, write_inputs


@pytest.fixture(scope="module")
def cube_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cubes")
    inputs = write_inputs(root)
    with pytest.MonkeyPatch.context() as mp:
        return run_both(root, inputs, ["test.eval_on_cubes=true"], mp)


def test_cli_test_mode_on_cubes_vs_jax(cube_run):
    out_j, out_p = cube_run
    # 2 target views x 6 faces of 32x32
    compare_outputs(out_j, out_p, n_images=12, cubes=True)
