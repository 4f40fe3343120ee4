"""The LM family's steps on a device mesh, MoE configs: grok-1 (four
experts, every layer MoE) and deepseek-v3 (MLA, a dense first layer,
eight experts with a shared one, the MTP head).  The checks and
tolerances are ``test_torch_lm_mesh.py``'s (its docstring says why); the
MoE cases live here so that the reference's compiles spread over two
workers.

Against the port's one device, on every mesh in float32 and bfloat16,
the routing is teacher-forced: the mesh's router takes one device's
choices, each position the rows of its own tokens (a near-tie flip would
otherwise cascade through the experts' shared capacity), and its own
choices are held to them but for ties (``chip_smoke.LM_MESH_TIE``).  On
``(1, 3)`` neither expert count divides the model axis, so both fall back
to tensor parallelism inside each expert (the specs' ``ep_ok``).

Against the reference's mesh run, in float32 (its mesh run cannot have
its routes forced): the train step's loss and ``grad_norm`` at 1e-5, the
prefill and decode tokens where the port's one-device logits decide them,
the final cache; grok's fallback on a ``(1, 8)`` mesh of eight host
devices (the reference's jit refuses the uneven ``(1, 3)`` shards).  The
other meshes' reference runs are in ``test_torch_lm_mesh_moe_ref.py``
(float32) and ``test_torch_lm_mesh_moe_bf16.py`` (bfloat16).
"""
import pytest
import torch

from repro_torch.models import moe, sharding

from test_torch_lm_mesh import (DTYPES, MESH_IDS, MESHES, MOE,  # noqa: F401
                                _one_torch_thread, check_against_one_device,
                                check_against_reference, chip_smoke,
                                mesh_of, ref_fixture)

REF_JOBS = [
    ("grok-1-314b-smoke", "float32", (2, 2), ("train", "prefill", "decode")),
    ("grok-1-314b-smoke", "float32", (1, 8), ("train",)),
    ("deepseek-v3-671b-smoke", "float32", (2, 2),
     ("train", "prefill", "decode")),
]
reference_runs = ref_fixture(REF_JOBS, ndev=8)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_moe_mesh_steps_equal_one_device(name, dtype, shape, reference_runs):
    # the reference's subprocess (the fixture) runs meanwhile
    row = check_against_one_device(name, dtype, shape)
    assert row["train"]["router_flips"] is not None


def _global_moe(x, p, top_k, factor):
    return moe.moe_apply(p, x, top_k=top_k, capacity_factor=factor)


@pytest.mark.parametrize("ep", [True, False])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 1, 2)],
                         ids=["2x2", "4x1", "2x1x2"])
def test_global_capacity_and_overflow_order(shape, ep):
    """The dispatch over tokens spread on the batch axes keeps the
    reference's global semantics: the capacity from the global T and the
    overflow decided by the global stable order of (expert, token) — at
    a capacity factor of 0.5 a quarter of the assignments overflow, and
    which do is the global order's choice, not each position's.  The
    outputs and the aux loss equal one ``moe_apply`` over all the tokens
    (float64), with experts over ``model`` (EP) or every expert on every
    position with its ``moe_d_ff`` split (the fallback)."""
    mesh = mesh_of(shape)
    lay = sharding.layout(mesh)
    gen = torch.Generator().manual_seed(5)
    t, d, e, ff, k = 12, 8, 4, 6, 2
    p = {"router": {"w": torch.randn(d, e, generator=gen,
                                     dtype=torch.float64)},
         "experts": {n: torch.randn(*s, generator=gen, dtype=torch.float64)
                     for n, s in (("w_gate", (e, d, ff)), ("w_in", (e, d, ff)),
                                  ("w_out", (e, ff, d)))}}
    x = torch.randn(t, d, generator=gen, dtype=torch.float64)
    want, aux = _global_moe(x, p, k, 0.5)
    cap = moe.capacity(t, k, e, 0.5)
    assert cap * e < t * k  # assignments overflow
    dp = tuple(a for a in ("pod", "data") if a in lay.names)
    xs = sharding.shard_tensor(x, (dp,), mesh).shards
    ex = {n: sharding.shard_tensor(
        v, ("model",) if ep else ((None, None, "model") if n != "w_out"
                                  else (None, "model")), mesh).shards
        for n, v in p["experts"].items()}
    mp = {"router": [{"w": p["router"]["w"]}] * lay.n, "experts": ex}
    ys, auxes = moe.moe_apply_mesh(mesh, mp, xs, top_k=k, ep=ep, dp=dp,
                                   capacity_factor=0.5)
    got = sharding.unshard(sharding.ShardedTensor(
        ys, (dp, None), tuple(x.shape), mesh))
    assert torch.allclose(got, want, atol=1e-12)
    total = sum(float(auxes[q]) for q in lay.groups(dp)[0])
    assert abs(total - float(aux)) < 1e-12


def test_moe_layouts_follow_the_specs():
    """grok's 4 experts on (2, 2) lie in blocks of 2 over ``model`` (the
    specs' ``P(tp, ...)``, where the reference's docstring says cyclic);
    on (1, 3) every position holds all four with a third of ``moe_d_ff``."""
    from repro_torch.models import steps as tsteps

    from test_torch_lm_mesh import cfg_of, port_params

    cfg = cfg_of("grok-1-314b-smoke", "float32")
    params = port_params("grok-1-314b-smoke", "float32")
    for shape, want in (((2, 2), (2, 32, 128)), ((1, 3), (4, 64, 43))):
        _, info = tsteps.build_lm_train_step(cfg, mesh_of(shape))
        sp = info["shard"](params)
        wg = sp["layers"]["moe"]["experts"]["w_gate"]
        assert tuple(wg.shards[0].shape[1:]) == want
        assert info["plan"].ep == (shape == (2, 2))
        if shape == (2, 2):
            full = params["layers"]["moe"]["experts"]["w_gate"]
            assert torch.equal(wg.shards[1], full[:, 2:4, 0:32])


@pytest.mark.parametrize("name,dtype,shape,kinds", REF_JOBS,
                         ids=[f"{n}-{d}-{'x'.join(map(str, m))}"
                              for n, d, m, _ in REF_JOBS])
def test_moe_mesh_steps_equal_the_references_mesh_run(reference_runs, name,
                                                      dtype, shape, kinds):
    check_against_reference(reference_runs, name, dtype, shape, kinds,
                            full_train=False)
