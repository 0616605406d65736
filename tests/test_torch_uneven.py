"""Leaves, activations and caches that do not divide over ``model``, held
whole on every rank where the reference replicates them, on the CPU with
gloo: ranks spawned by ``launch.mesh.run_ranks`` over (data 1, model 3)
and (data 2, model 2), one spawn a mesh for the module, the rank bodies in
``tests/_torch_uneven_ranks.py``.  Weights are drawn with numpy in the
reference's schema (``test_torch_tensor_parallel._draw``) and carried
across with ``params_from_numpy``.

Over (data 1, model 3), where none of the smoke widths divides (4 heads,
64 widths, ``ff`` 128, vocab 256; SmolLM's 3 heads, 48 and 96 divide and
add nothing here):

* Qwen3-4B, DeepSeek-V2, RWKV6 (in float64, the reference with x64 on),
  Hymba and Whisper: ``prefill_fn`` logits within 1e-5 of max|logit| of
  the reference's, and ``serve_lm`` tokens equal to one process's;
* a ``train(mesh=)`` run of Qwen3-4B and of RWKV6 in float64: losses
  within 1e-5 of one process's;
* a Whisper self cache of 64 positions (whole: 64 does not divide 3)
  decoded against one process.

Over (data 2, model 2): caches of 15 positions (whole over model) for
SmolLM (its 3 heads cut inside a head), Qwen3-4B and DeepSeek-V2 (its one
dispatch group spanning the data ranks), prefilled and decoded against
one process, and a 3-head MLA model whose ``wq``, ``wkv_b`` and ``wo``
are each cut inside a head: its prefill against the reference's, its
decode over a 16-position cache cut on positions (the absorbed form over
cut columns) against one process, and a model of 16 KV heads of 16 whose
cache holds 8 of them a rank.  Decode logits are held within 1e-4 of
max|logit|, the tolerance of the other tensor-parallel decode tests.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_uneven_ranks as ranks
from repro.configs import get_bundle as ref_get_bundle
from repro.models import transformer as ref_lm
from repro.models.common import schema_pspecs as ref_schema_pspecs
from repro.models.registry import make_lm_bundle as ref_make_lm_bundle
from repro_torch.launch.serve import serve_lm
from repro_torch.launch.train import train
from repro_torch.models.common import params_from_numpy
from test_torch_tensor_parallel import _close, _draw

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_FWD, REL_DEC, REL_LOSS = 1e-5, 1e-4, 1e-5
WHISPER_LEN = 64
F64 = ("rwkv6-1.6b",)
# (data 2, model 2): case -> the cache length it decodes over
UNEVEN_CACHES = {"smollm-135m": ranks.UNEVEN_LEN, "qwen3-4b": ranks.UNEVEN_LEN,
                 "deepseek-v2-236b": ranks.UNEVEN_LEN, "mla3": 16,
                 "kv16": ranks.UNEVEN_LEN}


def _ref_bundle(case: str):
    if case in ranks.CONFIGS:
        cfg = ranks.CONFIGS[case]()
        kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        if cfg.mla is not None:
            kw["mla"] = ref_lm.MLAConfig(**dataclasses.asdict(cfg.mla))
        return ref_make_lm_bundle(ref_lm.LMConfig(**kw))
    return ref_get_bundle(case, smoke=True)


def _case_inputs(case: str, seed: int, s: int, **extra) -> tuple:
    """numpy weights, tokens (and Whisper's frames) of a case, and the
    reference's prefill logits on them.  RWKV6's weights are float64 and
    the reference runs with x64 on: its random-weight stack amplifies fp32
    rounding to about 1e-5 of max|logit| in either package (the
    reference's fp32 logits lie 1.3e-5 from its x64 ones on this draw)."""
    rb = _ref_bundle(case)
    rng = np.random.default_rng(seed)
    p = _draw(rb.schema, rng)
    if case in F64:
        p = jax.tree.map(lambda v: v.astype(np.float64), p)
        extra["param_dtype"] = "float64"
    toks = rng.integers(0, rb.cfg.vocab, (ranks.B * 2, s)).astype(np.int32)
    a = {"params": p, "tokens": toks, **extra}
    batch = {"tokens": jnp.asarray(toks)}
    if rb.family == "encdec":
        a["frames"] = rng.standard_normal(
            (ranks.B * 2, rb.cfg.enc_len, rb.cfg.d_model)).astype(np.float32)
        batch["frames"] = jnp.asarray(a["frames"])
    with jax.enable_x64(case in F64):
        want = np.asarray(rb.prefill_fn(jax.tree.map(jnp.asarray, p), batch))
    return a, want


@pytest.fixture(scope="module")
def model3_cases():
    inputs, ref = {}, {}
    for i, arch in enumerate(ranks.ARCHS):
        inputs[arch], ref[arch] = _case_inputs(arch, 200 + i, ranks.S,
                                               serve=True)
    return inputs, ref


@pytest.fixture(scope="module")
def data2_model2_cases():
    inputs, ref = {}, {}
    for i, (case, n) in enumerate(UNEVEN_CACHES.items()):
        inputs[case], ref[case] = _case_inputs(case, 300 + i, n, decode_len=n)
    return inputs, ref


@pytest.fixture(scope="module")
def model3(tmp_path_factory, model3_cases):
    return run(tmp_path_factory, 3, model3_cases[0])


@pytest.fixture(scope="module")
def data2_model2(tmp_path_factory, data2_model2_cases):
    return run(tmp_path_factory, 4, data2_model2_cases[0])


def run(tmp_path_factory, world, inputs):
    from repro_torch.launch.mesh import run_ranks

    return run_ranks(ranks.uneven_ranks, world, inputs, WHISPER_LEN,
                     store_path=str(tmp_path_factory.mktemp(f"unev{world}")
                                    / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


def _rows(runs, key, case, model: int):
    """The global batch's rows from the ranks of model coordinate 0."""
    return np.concatenate([r[key][case] if key == "prefill" else
                           r[key][case]["logits"] for r in runs[::model]])


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_prefill_over_model3_matches_reference(model3, model3_cases, arch):
    _, ref = model3_cases
    _close(_rows(model3, "prefill", arch, 3), ref[arch], REL_FWD, arch)
    for r in model3:
        assert np.array_equal(r["prefill"][arch], model3[0]["prefill"][arch])


class _MeshShape:
    """What the reference's ``spec_to_pspec`` reads of a mesh."""

    shape = {"data": 1, "model": 3}


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_leaves_are_cut_as_the_reference_places_them(model3, arch):
    """Each rank's leaves have the shapes of the reference's placement on
    (data 1, model 3): whole where no width divides 3 (every leaf but
    DeepSeek-V2's MLA query projection, whose 96 columns are cut inside
    its 24-wide heads)."""
    specs = ref_schema_pspecs(_ref_bundle(arch).schema, _MeshShape())
    want = {}
    for path, spec in _items(specs, is_leaf=lambda x: isinstance(x, tuple)):
        shape = _items_at(_ref_bundle(arch).schema, path).shape
        want["/".join(path)] = tuple(n // (3 if e == "model" else 1)
                                     for n, e in zip(shape, tuple(spec)))
    cut = [k for k, v in want.items()
           if v != _items_at(_ref_bundle(arch).schema, k.split("/")).shape]
    assert cut == (["dense_layers/wq", "moe_layers/wq"]
                   if arch == "deepseek-v2-236b" else []), cut
    for r in model3:
        assert r["local"][arch] == want


def _items(tree, prefix=(), is_leaf=lambda x: False):
    for k in sorted(tree):
        if isinstance(tree[k], dict) and not is_leaf(tree[k]):
            yield from _items(tree[k], prefix + (k,), is_leaf)
        else:
            yield prefix + (k,), tree[k]


def _items_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_serve_over_model3_equals_one_process(model3, model3_cases, arch):
    inputs, _ = model3_cases
    want = serve_lm(arch, smoke=True, device="cpu", graphs=False,
                    params=params_from_numpy(inputs[arch]["params"], "cpu"),
                    param_dtype=ranks.param_dtype(inputs[arch]),
                    **ranks.SERVE)
    for r in model3:
        assert np.array_equal(r["serve"][arch], want.numpy()), arch


@pytest.mark.parametrize("arch,dtype", [("qwen3-4b", torch.float32),
                                        ("rwkv6-1.6b", torch.float64)])
def test_train_over_model3_equals_one_process(model3, arch, dtype):
    want = train(arch, smoke=True, device="cpu", graphs=False,
                 param_dtype=dtype, **ranks.TRAIN)
    for r in model3:
        got = r["train"][arch]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert abs(a - b) <= REL_LOSS * abs(b), (arch, got, want)


def test_whisper_self_cache_of_64_over_model3(model3, model3_cases):
    """64 positions do not divide 3: the self cache is whole on every rank
    and each decode step writes and reads it as one device does."""
    inputs, _ = model3_cases
    a = inputs["whisper-medium"]
    bundle = ranks.port_bundle("whisper-medium")
    want = ranks._whisper_decoded(bundle, params_from_numpy(a["params"], "cpu"),
                                  None, torch.from_numpy(a["tokens"]),
                                  WHISPER_LEN)
    _close(_rows(model3, "decode", "whisper-medium", 3), want["logits"],
           REL_DEC, "whisper decode")
    for r in model3:
        assert r["decode"]["whisper-medium"]["cache"]["k"][2] == WHISPER_LEN


@pytest.mark.parametrize("case", list(UNEVEN_CACHES))
def test_uneven_caches_over_data2_model2(data2_model2, data2_model2_cases,
                                         case):
    """Prefill then decode over a cache whose positions do not divide over
    model 2 (15, held whole: ``make_cache(2, 15)``), or, for the 3-head
    MLA model, over a 16-position cache cut on positions with ``wkv_b``
    cut inside heads: every call's logits against one process's."""
    inputs, _ = data2_model2_cases
    a = inputs[case]
    bundle = ranks.port_bundle(case)
    want = ranks._decoded(bundle, params_from_numpy(a["params"], "cpu"), None,
                          torch.from_numpy(a["tokens"]), a["decode_len"],
                          ranks.P)
    _close(_rows(data2_model2, "decode", case, 2), want["logits"], REL_DEC,
           f"{case} decode")
    n = UNEVEN_CACHES[case] // (2 if case == "mla3" else 1)
    for r in data2_model2:
        shapes = r["decode"][case]["cache"]
        assert all(s[2] == n for s in shapes.values()), shapes
        if case == "kv16":  # the KV heads over model
            assert all(s[3] == 8 for s in shapes.values()), shapes


@pytest.mark.parametrize("case", list(UNEVEN_CACHES))
def test_prefill_over_data2_model2_matches_reference(data2_model2,
                                                     data2_model2_cases, case):
    _, ref = data2_model2_cases
    _close(_rows(data2_model2, "prefill", case, 2), ref[case], REL_FWD, case)
