"""The LM family's MoE steps on a device mesh in bfloat16 against the
reference's own mesh run: deepseek-v3 (MLA, a dense first layer, the
MTP head) on ``(1, 4)``, the mesh that ``test_torch_lm_mesh_moe_bf16.py``
leaves out (its docstring states the checks and their bounds).  A file
of its own, so that the reference's bfloat16 compiles spread over
another worker.
"""
import pytest

from test_torch_lm_mesh import (FULL, _one_torch_thread,  # noqa: F401
                                check_against_reference, ref_fixture,
                                ref_ids)

REF_JOBS = [
    ("deepseek-v3-671b-smoke", "bfloat16", (1, 4), FULL),
]
reference_runs = ref_fixture(REF_JOBS)


@pytest.mark.parametrize("name,dtype,shape,kinds", REF_JOBS,
                         ids=ref_ids(REF_JOBS))
def test_moe_mesh_steps_in_bfloat16_equal_the_references_mesh_run(
        reference_runs, name, dtype, shape, kinds):
    check_against_reference(reference_runs, name, dtype, shape, kinds,
                            full_train=False)
