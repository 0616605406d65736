"""The port's program space against the reference's, cell for cell.

``CodedPipeline.program_space`` and ``CodedDecoderPipeline.program_space``
enumerate every program a pipeline can launch; the analysis gate runs on
them.  Here the port's cells equal the reference's (which run here: the
reference's ``program_space`` needs only ``jax.eval_shape``) field for
field and in order — ``cell_id``, ``kind``, ``mode``, ``layer``,
``bucket``, ``cache_key``, ``allowed_const_shapes``, ``donate_argnums``
and the argument shapes and dtypes — for the three CNNs at smoke size,
fused and unfused, and the LM decoder on ``smollm_135m.smoke()``, coded
and uncoded, on the analysis gate's own configurations.

What the port changes on purpose, listed here and nowhere else:

- backend names: the reference's ``lax`` / ``pallas`` are the port's
  ``torch`` / ``kernel`` (they appear in the LM rounds' cache keys);
- ``donate_argnums``: torch has no buffer donation, so the reference is
  built with ``donate_transitions=False`` (see README);
- the LM worker's coded weights: the reference's ``(..., ell_b, d_in,
  ob)`` blocks are the port's ``(..., d_in, ell_b * ob)`` (the blocks side
  by side, one K2 launch for all of them);
- dtypes: none — token ids and positions are int32 on both sides.

The glue programs take their weights as arguments on both sides; each is
held within 1e-6 relative of the reference's on the same numpy inputs
(fp32 elementwise and reduction work in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as ref_smollm
from repro.core.decoder_pipeline import UncodedPlan as RefUncodedPlan
from repro.core.decoder_pipeline import \
    build_lm_decoder_pipeline as ref_build_lm
from repro.core.pipeline import build_cnn_pipeline as ref_build_cnn
from repro.models.cnn import CNN_SPECS as REF_CNN_SPECS
from repro.models.cnn import input_hw as ref_input_hw
from repro_torch.analysis import contracts
from repro_torch.models import transformer as lm

BACKEND_NAMES = {"lax": "torch", "pallas": "kernel"}
REF_BACKEND = {v: k for k, v in BACKEND_NAMES.items()}
DTYPE_MAP: dict[str, str] = {}  # reference dtype -> port dtype: none differ
ARCHS = ("lenet5", "alexnet", "vgg16")
CNN_CASES = [(a, b, f) for a in ARCHS for b in ("torch", "kernel")
             for f in (False, True)]
LM_CASES = [(k, b) for k in ("coded", "uncoded") for b in ("torch", "kernel")]
TOL_GLUE = 1e-6


def _norm(v):
    """A cache key in comparable form: geometry dataclasses as their fields,
    backend names in the port's spelling."""
    if dataclasses.is_dataclass(v):
        return tuple(sorted((f.name, _norm(getattr(v, f.name)))
                            for f in dataclasses.fields(v)))
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if isinstance(v, str):
        return BACKEND_NAMES.get(v, v)
    return v


def _ref_args(cell, lm_worker=False):
    args = [(tuple(a.shape), DTYPE_MAP.get(str(a.dtype), str(a.dtype)))
            for a in cell.args]
    if lm_worker:  # (..., eb, d_in, ob) -> (..., d_in, eb * ob)
        shape, dtype = args[1]
        *lead, eb, d_in, ob = shape
        args[1] = (tuple(lead) + (d_in, eb * ob), dtype)
    return args


def _port_args(cell):
    return [(tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for a in cell.args]


def _fields(cell):
    return (cell.cell_id, cell.kind, cell.mode, cell.layer, cell.bucket,
            _norm(cell.cache_key),
            tuple(tuple(s) for s in cell.allowed_const_shapes),
            tuple(cell.donate_argnums))


def _ref_cnn(cfg: contracts.ContractConfig):
    _, layers = REF_CNN_SPECS[cfg.arch]
    params = {l.name: np.zeros((l.out_ch, l.in_ch, l.kernel, l.kernel),
                               np.float32) for l in layers}
    return ref_build_cnn(
        cfg.arch, params, n=cfg.n, default_kab=cfg.kab,
        input_hw=ref_input_hw(cfg.arch, smoke=True),
        backend=REF_BACKEND[cfg.backend], interpret=True,
        bucket_sizes=cfg.buckets, fuse_transitions=cfg.fused,
        donate_transitions=False)


def _ref_lm(cfg: contracts.DecoderContractConfig):
    bundle = ref_smollm.smoke()
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                          bundle.param_shapes(np.float32))
    plan = RefUncodedPlan(cfg.n) if cfg.plan_kind == "uncoded" else None
    return ref_build_lm(
        bundle.cfg, params, cfg.n, k_b=None if plan else cfg.k_b, plan=plan,
        backend=REF_BACKEND[cfg.backend], interpret=True,
        bucket_sizes=cfg.buckets, max_len=32)


@pytest.fixture(scope="module")
def cnn_pairs():
    out = {}
    for arch, backend, fused in CNN_CASES:
        cfg = contracts.ContractConfig(arch, backend, fused)
        port = contracts.build_pipeline(cfg, "cpu")
        ref = _ref_cnn(cfg)
        out[(arch, backend, fused)] = (
            port, list(port.program_space()), ref, list(ref.program_space()))
    return out


@pytest.fixture(scope="module")
def lm_pairs():
    out = {}
    for kind, backend in LM_CASES:
        cfg = contracts.DecoderContractConfig(kind, backend)
        port = contracts.build_decoder_pipeline(cfg, "cpu")
        ref = _ref_lm(cfg)
        out[(kind, backend)] = (
            port, list(port.program_space()), ref, list(ref.program_space()))
    return out


@pytest.mark.parametrize("arch,backend,fused", CNN_CASES)
def test_cnn_cells_equal_reference(cnn_pairs, arch, backend, fused):
    _, cells, _, ref_cells = cnn_pairs[(arch, backend, fused)]
    assert len(cells) == len(ref_cells)
    for c, r in zip(cells, ref_cells):
        assert _fields(c) == _fields(r)
        assert _port_args(c) == _ref_args(r), c.cell_id
        assert c.trace_signature[:2] == r.trace_signature[:2]
        assert c.eager_only == ""  # every CNN cell can be captured


@pytest.mark.parametrize("kind,backend", LM_CASES)
def test_decoder_cells_equal_reference(lm_pairs, kind, backend):
    _, cells, _, ref_cells = lm_pairs[(kind, backend)]
    assert len(cells) == len(ref_cells)
    for c, r in zip(cells, ref_cells):
        assert _fields(c) == _fields(r)
        worker = c.kind == "worker"
        assert _port_args(c) == _ref_args(r, lm_worker=worker), c.cell_id
        # the decode inverse stays on the host, where K3 takes it by value
        assert bool(c.eager_only) == (c.kind == "decoder")
        assert [a.host for a in c.args] == [
            c.kind == "decoder" and i == 1 for i in range(len(c.args))]


@pytest.mark.parametrize("arch,backend,fused", CNN_CASES)
def test_cnn_counts_equal_reference(cnn_pairs, arch, backend, fused):
    port, cells, ref, ref_cells = cnn_pairs[(arch, backend, fused)]
    for name in ("num_geometries", "num_transitions", "num_worker_programs",
                 "program_trace_bound"):
        assert getattr(port, name) == getattr(ref, name), name
    sigs = {c.trace_signature for c in cells if c.kind in ("worker", "transition")}
    ref_sigs = {r.trace_signature for r in ref_cells
                if r.kind in ("worker", "transition")}
    assert len(sigs) == len(ref_sigs) <= 2 * port.program_trace_bound


@pytest.mark.parametrize("kind,backend", LM_CASES)
def test_decoder_counts_equal_reference(lm_pairs, kind, backend):
    port, _, ref, _ = lm_pairs[(kind, backend)]
    for name in ("num_geometries", "num_transitions", "num_rounds_per_step",
                 "program_trace_bound"):
        assert getattr(port, name) == getattr(ref, name), name
    # the reference's decoder has no num_worker_programs: count its caches
    assert port.num_worker_programs == (
        len(ref._batch_programs) + len(ref._cluster_programs))


# -- the glue programs -----------------------------------------------------
def _close(got, want, rel=TOL_GLUE):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def _glue_inputs(pipe, bucket=2, seed=0):
    rng = np.random.default_rng(seed)
    cfg = pipe.cfg
    d, v = cfg.d_model, cfg.vocab

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "embed": (f32(v, d), rng.integers(0, v, bucket).astype(np.int32)),
        "norm": (f32(bucket, d), f32(d)),
        "add": (f32(bucket, d), f32(bucket, d)),
        "act": (f32(bucket, 2 * cfg.d_ff),),
        "finish": (f32(bucket, d), f32(d), f32(d, v)),
    }


@pytest.mark.parametrize("name", ["embed", "norm", "add", "act", "finish"])
def test_glue_fn_matches_reference(lm_pairs, name):
    port, _, ref, _ = lm_pairs[("coded", "torch")]
    args = _glue_inputs(port)[name]
    got = port.glue_fn(name)(*(torch.as_tensor(a) for a in args))
    want = ref._glue_fn(name)(*(jnp.asarray(a) for a in args))
    if name == "finish":
        _close(got[0], want[0])
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].dtype == torch.int32
    else:
        _close(got, want)
    assert port.glue_fn(name) is port.glue_fn(name)  # one program a name


def test_attention_glue_matches_reference(lm_pairs):
    """The decode-attention glue, with its RoPE frequencies now computed in
    the program, against the reference's on one write-and-attend step."""
    port, _, ref, _ = lm_pairs[("coded", "torch")]
    cfg = port.cfg
    rng = np.random.default_rng(1)
    b, hkv, hd = 2, cfg.n_kv_heads, cfg.head_dim
    qkv = rng.standard_normal((b, port.qkv_dim)).astype(np.float32)
    ck = rng.standard_normal((b, port.max_len, hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, port.max_len, hkv, hd)).astype(np.float32)
    pos = np.array([3, 7], np.int32)
    got = port.attn_fn(0)(torch.as_tensor(qkv), torch.as_tensor(ck.copy()),
                          torch.as_tensor(cv.copy()), torch.as_tensor(pos))
    want = ref.attn_fn(0)(jnp.asarray(qkv), jnp.asarray(ck), jnp.asarray(cv),
                          jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)
    assert port.attn_fn(0) is port.attn_fn(1)  # one program a window


def test_served_glue_reads_no_weights_of_its_own(lm_pairs):
    """``embed`` / ``act`` / ``finish`` are the glue programs applied to the
    pipeline's weights: the same numbers as calling ``glue_fn`` directly."""
    port, _, _, _ = lm_pairs[("coded", "torch")]
    p = lm.map_params(lambda t: torch.randn(t.shape, generator=torch.Generator()
                                            .manual_seed(2)), port.params)
    port.embed_table, port.ln_f = p["embed"], p["ln_f"]
    port.head = p["embed"].t()
    toks = torch.tensor([1, 5], dtype=torch.int32)
    x = port.embed(toks)
    assert torch.equal(x, port.glue_fn("embed")(p["embed"], toks))
    logits, nxt = port.finish(x)
    want, want_nxt = port.glue_fn("finish")(x, p["ln_f"], p["embed"].t())
    assert torch.equal(logits, want) and torch.equal(nxt, want_nxt)
    gu = torch.randn(2, 2 * port.cfg.d_ff)
    assert torch.equal(port.act(gu), port.glue_fn("act")(gu))
