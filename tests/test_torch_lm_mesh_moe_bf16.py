"""The LM family's MoE steps on a device mesh in bfloat16 against the
reference's own mesh run, on every mesh the reference accepts (``(2,
2)``, ``(1, 4)``, ``(4, 1)``, ``(2, 1, 2)``): the train, prefill and
decode steps.  Neither run's routes are forced (the reference's mesh run
cannot have them forced), so a near-tie may route differently on the
two; the checks are those of ``test_torch_lm_mesh_moe.py``'s reference
runs at the bfloat16 bounds: the train step's loss and ``grad_norm``
(2**-5), the prefill and decode tokens where the port's one-device
logits decide them (margins over 2**-5), the final cache (2**-4).  The
routes themselves are held, forced, against the port's one device in
``test_torch_lm_mesh_moe.py``.  The meshes are split over this file
(grok on ``(2, 2)``, ``(4, 1)``, ``(2, 1, 2)``) and
``test_torch_lm_mesh_moe_bf16_more.py`` (deepseek on ``(1, 4)``), so
that the reference's bfloat16 compiles spread over two workers.
"""
import pytest

from test_torch_lm_mesh import (FULL, _one_torch_thread,  # noqa: F401
                                check_against_reference, ref_fixture,
                                ref_ids)

REF_JOBS = [
    ("grok-1-314b-smoke", "bfloat16", (2, 2), FULL),
    ("grok-1-314b-smoke", "bfloat16", (4, 1), FULL),
    ("grok-1-314b-smoke", "bfloat16", (2, 1, 2), FULL),
]
reference_runs = ref_fixture(REF_JOBS)


@pytest.mark.parametrize("name,dtype,shape,kinds", REF_JOBS,
                         ids=ref_ids(REF_JOBS))
def test_moe_mesh_steps_in_bfloat16_equal_the_references_mesh_run(
        reference_runs, name, dtype, shape, kinds):
    check_against_reference(reference_runs, name, dtype, shape, kinds,
                            full_train=False)
