"""The precision argument for K4's fp32 tiled kernel on ``wgmma``, on the CPU.

The kernel computes every fp32 product as three TF32 ones (3xTF32): q, k,
v and each key tile's p are split into a TF32 high and low part, ``a = hi
+ lo``, and ``lo*hi + hi*lo + hi*hi`` is summed in fp32; each key tile's
P.V is summed on its own and then added to the output (promotion).  K and
V are split once a launch into a scratch laid out as the ``wgmma``
descriptors read it, V transposed and its keys permuted within each 8-key
group so that the score accumulators are P.V's A fragments as they lie.
``flash_attention_3xtf32_plain`` is that arithmetic in torch ops and
``split_kv_plain`` that layout; here they are held to

  * the reference's ``flash_attention_pallas`` in interpret mode, within
    2e-5 of max|reference|, causal and not, Sq != Sk, GQA rep 4, D 64 and
    128;
  * float64: the 3xTF32 walk's error against ``flash_attention_plain`` in
    float64 at most ``FP64_RATIO`` times the fp32 plain version's, while
    one TF32 product (hi parts only) on the same draw is at least 10 times
    the 3xTF32 walk's, so the check tells the two apart;
  * the layout, read back from first principles (the 128-byte swizzle and
    the PTX ISA's register fragments of ``wgmma``): it holds ``split_tf32``
    of K and V bit for bit, zero past Sk, and P.V taken as the kernel takes
    it (A fragments straight from the score accumulators, B from the
    permuted V^T) equals P.V on exact small-integer data.

The tensor cores' own accumulation is not modelled (products are exact in
fp32 and summed in fp32 here): the card holds the kernel to the same
float64 ratio (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro_torch.kernels.tf32 import split_tf32
from repro_torch.kernels.flash_attn import kernel as k4

RNG = np.random.default_rng(34)
FP64_RATIO = 4.0  # chip_smoke.K4_FP64_RATIO
TK = k4.SPLIT_KEYS


def _qkv(bh, sq, sk, d, rep, dtype=np.float32):
    return tuple(torch.from_numpy(RNG.standard_normal(s).astype(dtype))
                 for s in ((bh, sq, d), (bh // rep, sk, d), (bh // rep, sk, d)))


@pytest.mark.parametrize("bh,sq,sk,d,rep,causal", [
    (4, 64, 64, 64, 1, True), (4, 48, 80, 64, 4, False),
    (8, 70, 70, 128, 4, True), (2, 40, 130, 128, 1, False)])
def test_3xtf32_walk_matches_the_pallas_kernel(bh, sq, sk, d, rep, causal):
    q, k, v = _qkv(bh, sq, sk, d, rep)
    got = k4.flash_attention_3xtf32_plain(q, k, v, causal=causal, rep=rep)
    kr, vr = (t.repeat_interleave(rep, dim=0) for t in (k, v))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(kr.numpy()), jnp.asarray(vr.numpy()),
        causal=causal))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 2e-5 * float(np.abs(want).max()), err


def _one_tf32(q, k, v, causal, rep, tile=TK):
    """The same walk with one TF32 product (hi parts only)."""
    hi = lambda t: split_tf32(t)[0]
    k, v = (t.repeat_interleave(rep, dim=0) for t in (k, v))
    bh, sq, d = q.shape
    m = torch.full((bh, sq, 1), float("-inf"))
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[1], tile):
        x = hi(q) @ hi(k[:, k0:k0 + tile]).transpose(1, 2) * d ** -0.5
        if causal:
            keys = torch.arange(k0, k0 + x.shape[-1])[None, :]
            x = x.masked_fill((keys > rows)[None], float("-inf"))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + hi(p) @ hi(v[:, k0:k0 + tile])
        m = m_new
    return acc / l


@pytest.mark.parametrize("bh,sq,sk,d,rep,causal", [
    (4, 128, 128, 64, 2, True), (2, 96, 200, 128, 1, False),
    (5, 130, 130, 64, 5, True)])
def test_3xtf32_keeps_the_fp32_error_against_float64(bh, sq, sk, d, rep, causal):
    q, k, v = _qkv(bh, sq, sk, d, rep)
    want = k4.flash_attention_plain(q.double(), k.double(), v.double(),
                                    causal=causal, rep=rep)
    assert want.dtype == torch.float64

    def err(t):
        return float((t.double() - want).abs().max())

    plain = err(k4.flash_attention_plain(q, k, v, causal=causal, rep=rep))
    three = err(k4.flash_attention_3xtf32_plain(q, k, v, causal=causal, rep=rep))
    one = err(_one_tf32(q, k, v, causal, rep))
    assert three <= FP64_RATIO * plain, (three, plain)
    assert one >= 10 * three, (one, three)


def _slot_key(slot: int) -> int:
    """The key of an 8-key group that V^T's k-slot ``slot`` holds."""
    return 2 * slot if slot < 4 else 2 * (slot - 4) + 1


def _at(block: torch.Tensor, row: int, col: int) -> torch.Tensor:
    """Element (row, col) of a [rows][32 floats] block stored with the
    128-byte swizzle: 16-byte chunk c of a row at chunk c ^ (row % 8)."""
    return block[row * 32 + ((col // 4) ^ (row % 8)) * 4 + col % 4]


def _read_back(kv: torch.Tensor, sk: int, d: int):
    """K hi/lo and V hi/lo, (BHkv, Sk padded, D) each, read from the
    scratch by the layout's description, not by ``_split_kv_offsets``."""
    bhkv, nt = kv.shape[:2]
    out = torch.zeros((4, bhkv, nt * TK, d))
    for h in range(bhkv):
        for t in range(nt):
            for part in range(4):
                flat = kv[h, t, part]
                for key in range(TK):
                    for c in range(d):
                        if part < 2:  # K: d / 32 blocks of [keys][32]
                            x = _at(flat[(c // 32) * TK * 32:], key, c % 32)
                        else:  # V^T: TK / 32 blocks of [d][32 key slots]
                            g8, w = key % 32 // 8, key % 8
                            slot = next(s for s in range(8) if _slot_key(s) == w)
                            x = _at(flat[(key // 32) * d * 32:], c, 8 * g8 + slot)
                        out[part, h, t * TK + key, c] = x
    return out


@pytest.mark.parametrize("sk", [64, 100])
def test_split_layout_holds_the_split_operands(sk):
    d = 32 if sk == 100 else 64
    k, v = (torch.from_numpy(RNG.standard_normal((2, sk, d)).astype(np.float32))
            for _ in range(2))
    kv = k4.split_kv_plain(k, v)
    assert kv.numel() == k4.split_kv_numel(2, sk, d)
    back = _read_back(kv, sk, d)
    for part, t in enumerate((*split_tf32(k), *split_tf32(v))):
        assert torch.equal(back[part, :, :sk].view(torch.int32), t.view(torch.int32))
        assert not back[part, :, sk:].any()


def test_pv_from_the_score_accumulators_over_the_permuted_layout():
    """One warpgroup's P.V over one key tile as the kernel issues it.  In
    ``wgmma``'s fp32 accumulator layout lane (g, t4) of warp w holds
    element 4j + e at row 16w + g + 8(e >> 1), key 8j + 2 t4 + (e & 1); the
    m64k8 tf32 A fragment of k8 step kk takes registers (a0, a1, a2, a3)
    as (row 16w + g, k-slot t4), (row + 8, t4), (row, t4 + 4), (row + 8,
    t4 + 4).  The kernel hands it accumulators (4kk, 4kk + 2, 4kk + 1, 4kk
    + 3); B's k-slot s of step kk is V^T's column 8kk + s as the scratch
    holds it."""
    d = 64
    p = torch.from_numpy(RNG.integers(0, 8, (64, TK)).astype(np.float32))
    v = torch.from_numpy(RNG.integers(-8, 9, (1, TK, d)).astype(np.float32))
    kv = k4.split_kv_plain(v, v)
    vt_hi = kv[0, 0, 2]  # small integers: lo is zero
    assert not kv[0, 0, 3].any()
    a = torch.zeros((64, TK))
    for w in range(4):
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            acc = {4 * j + e: p[16 * w + g + 8 * (e >> 1), 8 * j + 2 * t4 + (e & 1)]
                   for j in range(TK // 8) for e in range(4)}
            for kk in range(TK // 8):
                frag = (acc[4 * kk], acc[4 * kk + 2], acc[4 * kk + 1], acc[4 * kk + 3])
                row = 16 * w + g
                a[row, 8 * kk + t4], a[row + 8, 8 * kk + t4] = frag[0], frag[1]
                a[row, 8 * kk + t4 + 4], a[row + 8, 8 * kk + t4 + 4] = frag[2], frag[3]
    b = torch.zeros((TK, d))
    for kk in range(TK // 8):
        for s in range(8):
            col = 8 * kk + s
            for n in range(d):
                b[col, n] = _at(vt_hi[(col // 32) * d * 32:], n, col % 32)
    assert not torch.equal(a, p)  # the keys are permuted ...
    assert torch.equal(a @ b, p @ v[0])  # ... the same on both sides
