"""The LM family's MoE steps on a device mesh against the reference's own
mesh run, beyond ``test_torch_lm_mesh_moe.py``'s ``(2, 2)`` and ``(1,
8)``: with them, an MoE config runs the train, prefill and decode steps
in float32 on every mesh the reference accepts (``(2, 2)``, ``(1, 4)``,
``(4, 1)``, ``(2, 1, 2)``).  The reference's mesh run cannot have its
routes forced, so, as in that file, the train step is held on its loss
and ``grad_norm`` (1e-5), the prefill and decode tokens where the port's
one-device logits decide them, and the final cache (1e-4).  A file of
its own, so that the reference's compiles spread over another worker.
"""
import pytest

from test_torch_lm_mesh import (FULL, _one_torch_thread,  # noqa: F401
                                check_against_reference, ref_fixture,
                                ref_ids)

REF_JOBS = [
    ("grok-1-314b-smoke", "float32", (1, 4), FULL),
    ("grok-1-314b-smoke", "float32", (4, 1), FULL),
    ("deepseek-v3-671b-smoke", "float32", (2, 1, 2), FULL),
]
reference_runs = ref_fixture(REF_JOBS)


@pytest.mark.parametrize("name,dtype,shape,kinds", REF_JOBS,
                         ids=ref_ids(REF_JOBS))
def test_moe_mesh_steps_equal_the_references_mesh_run(
        reference_runs, name, dtype, shape, kinds):
    check_against_reference(reference_runs, name, dtype, shape, kinds,
                            full_train=False)
