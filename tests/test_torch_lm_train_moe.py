"""The port's LM train step against the JAX package's on the MoE smoke
configs: grok-1 (every layer MoE) and deepseek-v3 (MLA, a dense first
layer, MoE layers and the MTP head), in float32 and bfloat16 at steps 0
and 2000, the routing teacher-forced.  The checks and tolerances are
``test_torch_lm_train_step.py``'s (its docstring says why); the MoE cases
live here so that the reference's compiles spread over two workers.
"""
import pytest

from test_torch_lm_train_step import (DTYPES, MOE, STEPS,  # noqa: F401
                                      _one_torch_thread, check_remat_off,
                                      check_step)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_moe_train_step_matches_the_reference(name, dtype, step):
    check_step(name, dtype, step)


def test_remat_off_gives_the_same_moe_step():
    check_remat_off("grok-1-314b-smoke")
