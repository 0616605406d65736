"""MoE dispatch over uneven placements against the reference's one-device
``moe_ffn``, on the CPU with gloo: ranks spawned by
``launch.mesh.run_ranks`` (2, 3 and 4 of them, one spawn a world size for
the module), each holding its rows of the tokens and its cut of the MoE
leaves (``schema_shardings``).  The rank bodies are in
``tests/_torch_uneven_ranks.py``.

The cases, each through ``moe_ffn``, ``moe_ffn_plain`` and ``moe_ffn``
under ``REPRO_BASELINE=1`` (the float-scatter dispatch, as the
reference's switch selects it), all within 1e-5 of max|y| of the
reference's ``moe_ffn`` on the whole batch:

* DeepSeek-V2's smoke MoE (8 experts, top 2, 2 shared) with its own one
  dispatch group over (data 2), (data 2, model 2) and (pod 2, data 2):
  the group spans the data ranks, so each rank gathers every rank's rows
  and dispatches the group as one device does;
* the same with 4 groups of 16 over 64 tokens (each rank's rows whole
  groups), 2 groups (each over two ranks of (pod 2, data 2)) and 3
  groups (group boundaries inside ranks' rows);
* a capacity factor of 0.5, so that entries drop, and which ones depends
  on the tokens other ranks hold;
* over (data 1, model 3) the smoke MoE whole (8 experts, ``ff`` 32 and
  the shared 64 do not divide 3);
* over (data 1, model 4) a MoE of 6 experts, ``d_ff_expert`` 32: the
  experts do not divide, each expert's ``ff`` is cut to 8 a rank and the
  router is whole.

Besides, DeepSeek-V2 smoke ``train(mesh=)`` over (data 2) with its one
dispatch group, FSDP on, within 1e-5 of one process's losses, and
``serve_lm(mesh=)`` at batch 4 over (data 2, model 2), each decode step's
4 tokens one group over both data ranks: tokens equal to one process's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_uneven_ranks as ranks
from repro.models import moe as ref_moe
from repro_torch.configs import get_bundle
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.serve import serve_lm
from repro_torch.launch.train import train
from repro_torch.models import moe
from repro_torch.models.common import params_from_numpy
from test_torch_tensor_parallel import _close, _draw

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_Y, REL_LOSS = 1e-5, 1e-5
TOKENS = 64
SMOKE_MOE = dict(n_routed=8, top_k=2, d_model=64, d_ff_expert=32, n_shared=2)
# case -> (MoEConfig fields, the meshes it runs over)
DATA = ("data2", "data2-model2", "pod2-data2")
CASES = {
    "groups1": (dict(SMOKE_MOE, dispatch_groups=1), DATA),
    "groups4": (dict(SMOKE_MOE, dispatch_groups=4), DATA),
    "groups2": (dict(SMOKE_MOE, dispatch_groups=2), ("pod2-data2",)),
    "groups3": (dict(SMOKE_MOE, dispatch_groups=3, d_model=64),
                ("pod2-data2",)),
    "drops": (dict(SMOKE_MOE, capacity_factor=0.5), DATA),
    "whole": (dict(SMOKE_MOE), ("model3",)),
    "ff_cut": (dict(n_routed=6, top_k=2, d_model=64, d_ff_expert=32,
                    n_shared=2), ("model4",)),
}
MESH_WORLD = {name: world for world, meshes in ranks.MOE_MESHES.items()
              for name in meshes}


def _tokens(case: str) -> int:
    return 48 if case == "groups3" else TOKENS


@pytest.fixture(scope="module")
def cases():
    """Each case's numpy weights and tokens, and the reference's output."""
    inputs, ref = {}, {}
    for i, (case, (fields, _)) in enumerate(CASES.items()):
        cfg = ref_moe.MoEConfig(**fields)
        rng = np.random.default_rng(100 + i)
        w = _draw(ref_moe.moe_schema(cfg), rng)
        x = rng.standard_normal((_tokens(case), cfg.d_model)).astype(np.float32)
        ref[case] = np.asarray(ref_moe.moe_ffn(jax.tree.map(jnp.asarray, w),
                                               jnp.asarray(x), cfg))
        inputs[case] = {"cfg": fields, "w": w, "x": x}
    return inputs, ref


@pytest.fixture(scope="module")
def serve_params():
    bundle = get_bundle("deepseek-v2-236b", smoke=True)
    return _draw(bundle.schema, np.random.default_rng(7))


def _spawn(tmp_path_factory, world, inputs, *args):
    mine = {c: a for c, a in inputs.items()
            if any(MESH_WORLD[m] == world for m in CASES[c][1])}
    return run_ranks(ranks.moe_ranks, world, mine, *args,
                     store_path=str(tmp_path_factory.mktemp(f"moe{world}")
                                    / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, cases):
    return _spawn(tmp_path_factory, 2, cases[0])


@pytest.fixture(scope="module")
def world3(tmp_path_factory, cases):
    return _spawn(tmp_path_factory, 3, cases[0])


@pytest.fixture(scope="module")
def world4(tmp_path_factory, cases, serve_params):
    return _spawn(tmp_path_factory, 4, cases[0], serve_params)


def _runs(request, mesh_name):
    return request.getfixturevalue(f"world{MESH_WORLD[mesh_name]}")


def _model(mesh_name) -> int:
    for meshes in ranks.MOE_MESHES.values():
        if mesh_name in meshes:
            sizes, names = meshes[mesh_name]
            return dict(zip(names, sizes))["model"]


PAIRS = [(c, m) for c, (_, meshes) in CASES.items() for m in meshes]


@pytest.mark.parametrize("case,mesh_name", PAIRS)
@pytest.mark.parametrize("route", ["y", "plain", "baseline"])
def test_moe_over_ranks_matches_reference(request, cases, case, mesh_name,
                                          route):
    """The ranks' rows (those of model coordinate 0, in data order) against
    the reference's ``moe_ffn`` over every token; the model ranks of a
    data rank agree."""
    _, ref = cases
    runs = [r[mesh_name]["moe"][case] for r in _runs(request, mesh_name)]
    m = _model(mesh_name)
    _close(np.concatenate([r[route] for r in runs[::m]]), ref[case], REL_Y,
           f"{case} {route}")
    for i, r in enumerate(runs):
        assert np.array_equal(r[route], runs[i // m * m][route])


def test_drop_case_drops_entries(cases):
    """The capacity factor of 0.5 drops entries of the whole batch's one
    group, so the ranks' agreement with the reference depends on the
    tokens the other ranks hold."""
    inputs, _ = cases
    a = inputs["drops"]
    cfg = moe.MoEConfig(**a["cfg"])
    r = moe.route(params_from_numpy(a["w"], "cpu"),
                  torch.from_numpy(a["x"])[None], cfg)
    assert not bool(r.keep.all())


def test_expert_cuts_follow_the_reference_placement(world3, world4):
    """Over model 3 the smoke's experts and router are whole; over model 4
    the 6 experts are whole and each expert's ``ff`` is cut (32 -> 8),
    the router whole; over (data 2, model 2) the experts are cut (8 ->
    4) with the router's columns; a span over the data axes names the
    axes whose ranks hold distinct rows."""
    for r in world3:
        got = r["model3"]["moe"]["whole"]
        assert got["w_gate"] == (8, 64, 32) and got["router"] == (64, 8)
    for r in world4:
        got = r["model4"]["moe"]["ff_cut"]
        assert got["w_gate"] == (6, 64, 8) and got["router"] == (64, 6)
        got = r["data2-model2"]["moe"]["groups1"]
        assert got["w_gate"] == (4, 64, 32) and got["router"] == (64, 4)
        assert got["row_axes"] == ("data",)
        assert r["pod2-data2"]["moe"]["groups1"]["row_axes"] == ("pod", "data")


def test_train_with_one_dispatch_group_over_data(world2):
    """DeepSeek-V2 smoke, its one dispatch group spanning both data ranks,
    FSDP on: the losses within 1e-5 of one process's."""
    want = train("deepseek-v2-236b", smoke=True, device="cpu", graphs=False,
                 **ranks.TRAIN)
    for r in world2:
        got = r["data2"]["train"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert abs(a - b) <= REL_LOSS * abs(b), (got, want)


def test_serve_over_data_and_model_equals_one_process(world4, serve_params):
    """``serve_lm`` of DeepSeek-V2 smoke at batch 4 over (data 2, model 2):
    each decode step's 4 tokens are one dispatch group over both data
    ranks; the tokens equal one process's, and the data axis carried the
    groups' gathers."""
    want = serve_lm("deepseek-v2-236b", smoke=True, device="cpu",
                    params=params_from_numpy(serve_params, "cpu"),
                    graphs=False, **ranks.SERVE)
    for r in world4:
        assert np.array_equal(r["data2-model2"]["serve"], want.numpy())
        assert r["data2-model2"]["by_axis"]["data"]["calls"] > 0
