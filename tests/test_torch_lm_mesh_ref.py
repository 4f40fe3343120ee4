"""The LM family's dense steps on a device mesh against the reference's
own mesh run, on the meshes and dtypes that ``test_torch_lm_mesh.py``'s
reference jobs leave out.  With them, a dense config runs the train,
prefill and decode steps in float32 and in bfloat16 on every mesh the
reference accepts: ``(2, 2)``, ``(1, 4)``, ``(4, 1)`` and ``(2, 1, 2)``
(its jit refuses ``(1, 3)``'s uneven shards).  The checks and tolerances
are ``test_torch_lm_mesh.py``'s (its docstring states them); a file of
their own, so that the reference's compiles spread over another worker.
"""
import pytest

from test_torch_lm_mesh import (FULL, _one_torch_thread,  # noqa: F401
                                check_against_reference, ref_fixture,
                                ref_ids)

REF_JOBS = [
    ("chatglm3-6b-smoke", "float32", (2, 2), FULL),
    ("qwen1.5-110b-smoke", "bfloat16", (4, 1), FULL),
    ("chatglm3-6b-smoke", "bfloat16", (2, 1, 2), FULL),
    ("qwen1.5-110b-smoke", "float32", (2, 1, 2), FULL),
]
reference_runs = ref_fixture(REF_JOBS)


@pytest.mark.parametrize("name,dtype,shape,kinds", REF_JOBS,
                         ids=ref_ids(REF_JOBS))
def test_dense_mesh_steps_equal_the_references_mesh_run(
        reference_runs, name, dtype, shape, kinds):
    check_against_reference(reference_runs, name, dtype, shape, kinds)
