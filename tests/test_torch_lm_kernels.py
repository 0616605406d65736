"""K3 (coded GEMM) and K4 (flash attention) of the LM path: their plain
PyTorch versions — what the wrappers run on CPU tensors, and what the
kernels are held against on the card — against the reference's Pallas
kernels in interpret mode and its pure-jnp oracles, on the same inputs.

Tolerances: 1e-6 relative to max|reference| for the coded GEMM (at most
16 fp32 products a sum, in another order); 1e-5 for attention (fp32
softmax over up to 384 keys, exponentials from another library); for
bf16 attention, one bf16 rounding of the output, 2^-7 of max|reference|
(both round p and the output to bf16, and a sum in another order may flip
either rounding).
"""
import functools
import importlib.util
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.crme import make_axis_codes, recovery_matrix
from repro.kernels.coded_gemm import crme_decode as ref_decode
from repro.kernels.coded_gemm import crme_encode as ref_encode
from repro.kernels.coded_gemm.kernel import coded_gemm_pallas_legacy
from repro.kernels.coded_gemm.ref import coded_gemm_ref
from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.flash_attn.ref import flash_attention_ref
from repro.models import common as ref_common
from repro_torch.kernels.coded_gemm import (coded_gemm, coded_gemm_plain,
                                            crme_decode, crme_encode)
from repro_torch.kernels.coded_gemm import kernel as k3
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attn import kernel as k4
from repro_torch.models import transformer as lm

RNG = np.random.default_rng(12)
REL_K3, REL_K4 = 1e-6, 1e-5


def _close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _t(a):
    return torch.as_tensor(np.asarray(a))


# (R_out, R_in, F): the LM path's decode (4x4) and encode (8x4) code
# shapes at its feature widths, the uncoded identity, ragged and R = 16
GEMM_SHAPES = [(4, 4, 960), (4, 4, 144), (4, 4, 3072), (8, 4, 576 * 240),
               (8, 4, 1536 * 144), (4, 4, 7), (16, 16, 700), (3, 5, 129),
               (1, 1, 1), (16, 2, 33)]


@pytest.mark.parametrize("r_out,r_in,f", GEMM_SHAPES)
def test_coded_gemm_plain_matches_pallas_legacy(r_out, r_in, f):
    code = RNG.standard_normal((r_out, r_in)).astype(np.float32)
    feats = RNG.standard_normal((r_in, f)).astype(np.float32)
    got = coded_gemm_plain(_t(code), _t(feats))
    if f <= 5000:  # interpret mode walks the grid in Python
        _close(got, coded_gemm_pallas_legacy(jnp.asarray(code), jnp.asarray(feats)),
               REL_K3)
    _close(got, coded_gemm_ref(jnp.asarray(code), jnp.asarray(feats)), REL_K3)
    before = k3.launches.count
    assert torch.equal(coded_gemm(_t(code), _t(feats)), got)  # CPU: the plain
    assert k3.launches.count == before  # no kernel launch on the CPU


@pytest.mark.parametrize("r_out,r_in,f", [(4, 4, 960), (4, 4, 3072), (8, 4, 576),
                                         (16, 16, 700)])
@pytest.mark.parametrize("as_numpy", [True, False])
def test_coded_gemm_host_code_matches_reference(r_out, r_in, f, as_numpy):
    """The code matrix as the path passes it, on the host (a numpy array or
    a CPU tensor), against the reference's oracle."""
    code = RNG.standard_normal((r_out, r_in)).astype(np.float32)
    feats = RNG.standard_normal((r_in, f)).astype(np.float32)
    got = coded_gemm(code if as_numpy else _t(code), _t(feats))
    _close(got, coded_gemm_ref(jnp.asarray(code), jnp.asarray(feats)), REL_K3)
    _close(coded_gemm_plain(code, _t(feats)), got, REL_K3)


def test_coded_gemm_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="1..16"):
        coded_gemm(torch.zeros(17, 4), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="1..16"):
        coded_gemm(torch.zeros(4, 17), torch.zeros(17, 8))
    with pytest.raises(ValueError, match="shapes"):
        coded_gemm(torch.zeros(4, 4), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="on the host"):  # code off the host
        coded_gemm(torch.zeros(4, 4, device="meta"), torch.zeros(4, 8))


def test_crme_encode_decode_match_reference_ops():
    """The reference's roundtrip case (``tests/test_kernels.py``): encode
    with the A code, decode any k_a coded streams, recover the parts."""
    k_a, n = 4, 5
    a, _ = make_axis_codes(k_a, 2, n)
    parts = RNG.standard_normal((k_a, 3, 6, 4)).astype(np.float32)
    coded = crme_encode(_t(parts), a.matrix)
    want = ref_encode(jnp.asarray(parts), a.matrix)
    assert coded.shape == (2 * n, 3, 6, 4)
    _close(coded, want, REL_K3)
    for sub in ([0, 1, 2, 3], [2, 5, 7, 9]):
        d = np.linalg.inv(a.matrix[:, sub].T)
        back = crme_decode(d, coded[sub])
        _close(back, ref_decode(d, want[jnp.asarray(sub)]), REL_K3)
        np.testing.assert_allclose(back.numpy(), parts, atol=1e-4)


@pytest.mark.parametrize("ids", list(itertools.combinations(range(4), 2)))
def test_crme_lm_plan_roundtrip(ids):
    """The LM plan (n=4, k_a=1, k_b=4): B-code weight encode, then the
    survivor decode of two workers' (ell_b=2) outputs recovers every
    column block, against the reference ops on the same inputs."""
    a_code, b_code = make_axis_codes(1, 4, 4)
    parts = RNG.standard_normal((4, 12, 5)).astype(np.float32)
    coded = crme_encode(_t(parts), b_code.matrix)  # (ell_b*n, 12, 5)
    _close(coded, ref_encode(jnp.asarray(parts), b_code.matrix), REL_K3)
    rows = coded.reshape(4, 2, 12, 5)[list(ids)].reshape(4, 12, 5)
    d = np.linalg.inv(recovery_matrix(a_code, b_code, list(ids)).T)
    back = crme_decode(d, rows)
    _close(back, ref_decode(d, jnp.asarray(rows.numpy())), REL_K3)
    np.testing.assert_allclose(back.numpy(), parts, atol=1e-4)


def _bshd(b, s, h, d, sk=None):
    sk = s if sk is None else sk
    q = RNG.standard_normal((b, s, h, d)).astype(np.float32)
    k = RNG.standard_normal((b, sk, h, d)).astype(np.float32)
    v = RNG.standard_normal((b, sk, h, d)).astype(np.float32)
    return q, k, v


def _flat(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


# the shapes of tests/test_flash_kernel.py
FLASH_CASES = [(2, 256, 2, 64, 128, 128), (1, 128, 4, 32, 64, 64),
               (2, 200, 1, 64, 128, 128), (1, 384, 2, 128, 128, 64)]


@pytest.mark.parametrize("b,s,h,d,bq,bk", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_ref(b, s, h, d, bq, bk, causal):
    q, k, v = (_flat(x) for x in _bshd(b, s, h, d))
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, flash_attention_ref(*args, causal=causal), REL_K4)
    _close(got, flash_attention_pallas(*args, causal=causal, bq=bq, bk=bk), REL_K4)
    before = k4.launches.count
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v), causal=causal), got)
    assert k4.launches.count == before


def _bf16_pair(x):
    """``x`` rounded to bf16 in both frameworks (round to nearest even)."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_bf16_matches_pallas(causal):
    """bf16 operands at the shape of the reference's bf16 test: the plain
    version against ``flash_attention_pallas`` in interpret mode on the
    same bf16 inputs (fp32 scores and softmax state, p rounded to bf16,
    a bf16 output)."""
    pairs = [_bf16_pair(_flat(x)) for x in _bshd(1, 128, 2, 64)]
    (qj, qt), (kj, kt), (vj, vt) = pairs
    got = flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(qj, kj, vj, causal=causal)
    assert want.dtype == jnp.bfloat16
    _close(got.float(), want.astype(jnp.float32), 2.0 ** -7)
    before = k4.launches.count
    assert torch.equal(flash_attention(qt, kt, vt, causal=causal), got)
    assert k4.launches.count == before


def test_flash_plain_bf16_near_fp32():
    """The reference's own bf16 check (``tests/test_flash_kernel.py``):
    bf16 attention within 3e-2 of fp32 attention on the fp32 inputs."""
    q, k, v = (_flat(x) for x in _bshd(1, 128, 2, 64))
    got = flash_attention_plain(*(_t(x).bfloat16() for x in (q, k, v)))
    want = flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2)


def _bf16_attention_variant(q, k, v, rep, *, scores_f64, round_p):
    """Causal bf16 attention as the plain version computes it, but with
    the scores summed in float64 (another order, then fp32) or with p
    left unrounded before P.V."""
    k, v = (t.repeat_interleave(rep, dim=0).float() for t in (k, v))
    if scores_f64:
        s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()).float()
    else:
        s = torch.einsum("bqd,bkd->bqk", q.float(), k)
    s = s * q.shape[-1] ** -0.5
    n = q.shape[1]
    s = s.masked_fill(torch.arange(n)[None, :] > torch.arange(n)[:, None], -1e30)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e.bfloat16().float() if round_p else e
    acc = torch.einsum("bqk,bkd->bqd", p, v)
    return (acc / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("seed", range(4))
def test_bf16_one_chunk_mismatch_bound_separates_p_rounding(seed):
    """``chip_smoke.py`` holds K4 in bf16 at the SmolLM-135M prefill (one
    32-key chunk) to the plain version's bits in all but
    ``K4_BF16_MISMATCH`` of the elements.  Fp32 scores summed in another
    order stay inside that share; a kernel that skipped rounding p to
    bf16 changes about a quarter of them, though it stays within 2^-7."""
    smoke = _smoke()
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
               for shape in ((36, 16, 64), (12, 16, 64), (12, 16, 64)))
    plain = flash_attention_plain(q, k, v, causal=True, rep=3)
    same = _bf16_attention_variant(q, k, v, 3, scores_f64=False, round_p=True)
    assert torch.equal(same, plain)
    reordered = _bf16_attention_variant(q, k, v, 3, scores_f64=True, round_p=True)
    unrounded = _bf16_attention_variant(q, k, v, 3, scores_f64=False, round_p=False)
    share = lambda x: float((x != plain).float().mean())
    assert share(reordered) <= smoke.K4_BF16_MISMATCH
    assert share(unrounded) > 0.2
    _close(unrounded.float(), plain.float(), smoke.TOL_K4_BF16)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_walk_rounds_where_the_pallas_kernel_does(causal, tile):
    """``flash_attention_tiled_plain``, the reference of the card's bit
    check of the tiled route, against ``flash_attention_pallas`` in
    interpret mode with ``tile``-row blocks, the same tiles (64: the
    mma.sync kernel's key tile; 128: the wgmma kernel's and the TPU
    kernel's own ``bk``), over four tiles of keys: fp32 within 1e-5 (and
    the one-pass plain version within 1e-6); bf16 within one rounding of
    each row's own max and all but ``K4_BF16_TILED_MISMATCH`` of the bits
    equal, where the one-pass plain version (p rounded against the row's
    final max) and the walk with p left whole each differ in more than
    ``K4_BF16_WHOLE_P`` of them."""
    smoke = _smoke()
    rng = np.random.default_rng(5)
    q, k, v = (_flat(rng.standard_normal((1, 4 * tile, 2, 64), dtype=np.float32))
               for _ in range(3))
    walk = functools.partial(k4.flash_attention_tiled_plain, causal=causal, tile=tile)
    got = walk(_t(q), _t(k), _t(v))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, flash_attention_pallas(*args, causal=causal, bq=tile, bk=tile), REL_K4)
    _close(got, flash_attention_plain(_t(q), _t(k), _t(v), causal=causal), 1e-6)
    (qj, qt), (kj, kt), (vj, vt) = (_bf16_pair(x) for x in (q, k, v))
    want = torch.from_numpy(np.asarray(flash_attention_pallas(
        qj, kj, vj, causal=causal, bq=tile, bk=tile).astype(jnp.float32)))
    got = walk(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    share = lambda x: float((x.float() != want).float().mean())
    assert smoke.row_err(got, want) <= smoke.TOL_K4_BF16
    assert share(got) <= smoke.K4_BF16_TILED_MISMATCH
    assert share(flash_attention_plain(qt, kt, vt, causal=causal)) > smoke.K4_BF16_WHOLE_P
    whole_p = walk(qt.float(), kt.float(), vt.float()).bfloat16()
    assert share(whole_p) > smoke.K4_BF16_WHOLE_P


@pytest.mark.parametrize("seed", range(3))
def test_tiled_bf16_check_separates_faults(seed):
    """``chip_smoke.check_tiled_bf16`` at a long causal GQA shape: scores
    summed in another order (the head dim permuted) pass it; p left whole,
    the middle key tile dropped (without a mask, where dropping is
    removing keys) and rows from 64 on scaled by 0.98 each fail it.  p
    left whole and the scaled rows stay within 2^-7 of max|plain|, the one
    check before it."""
    smoke = _smoke()
    rng = np.random.default_rng(seed)
    bh, s, d, rep = 4, 512, 128, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
               for shape in ((bh, s, d), (bh // rep, s, d), (bh // rep, s, d)))
    perm = torch.from_numpy(rng.permutation(d))
    walk = k4.flash_attention_tiled_plain
    check = smoke.check_tiled_bf16
    out = check("reordered", q, k, v, walk(q[..., perm].contiguous(),
                                           k[..., perm].contiguous(), v, rep=rep),
                True, rep)
    assert out["whole_p_mismatch_share"] > smoke.K4_BF16_WHOLE_P
    whole_p = walk(q.float(), k.float(), v.float(), rep=rep).bfloat16()
    keep = torch.cat([torch.arange(0, 256), torch.arange(320, s)])
    dropped = walk(q, k[:, keep].contiguous(), v[:, keep].contiguous(),
                   causal=False, rep=rep)
    scaled = (walk(q, k, v, rep=rep).float()
              * torch.where(torch.arange(s) >= 64, 0.98, 1.0)[None, :, None]
              ).bfloat16()
    for fault, causal, match in ((whole_p, True, "bits"),
                                 (dropped, False, "own max"),
                                 (scaled, True, "own max")):
        if causal:
            plain = flash_attention_plain(q, k, v, causal=causal, rep=rep)
            _close(fault.float(), plain.float(), smoke.TOL_K4_BF16)
        with pytest.raises(AssertionError, match=match):
            check("fault", q, k, v, fault, causal, rep)


def test_flash_plain_cross_lengths():
    """sq != sk with key padding in the Pallas kernel."""
    q, k, v = (_flat(x) for x in _bshd(2, 64, 2, 32, sk=200))
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=False)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, flash_attention_pallas(*args, causal=False, bq=64, bk=128), REL_K4)


@pytest.mark.parametrize("b,s,h,hkv,d", [(4, 16, 9, 3, 64), (2, 7, 3, 1, 16),
                                         (1, 70, 4, 2, 32)])
def test_flash_gqa_rep_matches_reference_attention(b, s, h, hkv, d):
    """``rep > 1``: query row ``bh`` reads K/V row ``bh // rep``, which is
    the reference's head order ``h = g * rep + r`` — held against the
    reference's causal GQA ``attention`` in its own (B, S, H, D) layout,
    both directly and through the port's ``_attend`` prefill route."""
    q = RNG.standard_normal((b, s, h, d)).astype(np.float32)
    k = RNG.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = RNG.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    mask = ref_common.make_attn_mask(jnp.asarray(pos), jnp.asarray(pos))
    want = ref_common.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    got = flash_attention_plain(_t(_flat(q)), _t(_flat(k)), _t(_flat(v)),
                                rep=h // hkv)
    _close(got.reshape(b, h, s, d).permute(0, 2, 1, 3), want, REL_K4)
    cfg = lm.LMConfig(name="t", layers=1, d_model=h * d, n_heads=h,
                      n_kv_heads=hkv, head_dim=d, d_ff=8, vocab=8)
    tp = torch.as_tensor(pos)
    routed = lm._attend(_t(q), _t(k), _t(v), tp, tp, cfg, None, start=0)
    _close(routed, want, REL_K4)


def test_flash_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(6, 4, 16)
    with pytest.raises(ValueError, match="rep"):
        flash_attention(q, torch.zeros(4, 4, 16), torch.zeros(4, 4, 16), rep=3)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros(2, 4, 16), torch.zeros(2, 5, 16), rep=3)
    with pytest.raises(ValueError, match="zero keys"):
        flash_attention(q, torch.zeros(2, 0, 16), torch.zeros(2, 0, 16), rep=3)
