"""The port's coded LM decoder pipeline (``core/decoder_pipeline.py``)
against the reference's, on smollm-135m-smoke with the reference's weights
(carried across as numpy) and the same tokens.

Covers: once-only weight encoding with the reference's coded values; one
decode step for EVERY C(4, 2) survivor subset against the reference
pipeline and the uncoded reference decoder (logits 1e-4 relative to
max|logit| — the decode multiplies fp32 rounding by the recovery matrix's
condition number — tokens exact); bit-exact replication vs the uncoded
plan; straggler and dead-worker decode through the port's cluster in the
simulated and threads modes; the batched prefill; and the bounded program
count over buckets.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as ref_smollm
from repro.core.decoder_pipeline import build_lm_decoder_pipeline as ref_build
from repro.models import transformer as ref_lm
from repro_torch.configs import smollm_135m
from repro_torch.core.decoder_pipeline import (CodedDecoderPipeline, UncodedPlan,
                                               build_lm_decoder_pipeline)
from repro_torch.models import transformer as lm
from repro_torch.runtime import ClusterDegraded, FcdccCluster, StragglerModel

N = 4
MAX_LEN = 32
PROMPT = [5, 9, 2, 7, 1]
PROMPT2 = [7, 1, 4, 2, 6]
REL = 1e-4


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


@pytest.fixture(scope="module")
def smoke():
    bundle = ref_smollm.smoke()
    params = bundle.init(jax.random.PRNGKey(0), jnp.float32)
    port = lm.lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return bundle.cfg, params, smollm_135m.smoke(), port


def _pipe(smoke, *, backend="kernel", k_b=4, n=N, plan=None, buckets=(2, 4)):
    _, _, cfg, port = smoke
    return build_lm_decoder_pipeline(
        cfg, port, n, k_b=None if plan else k_b, plan=plan, backend=backend,
        bucket_sizes=buckets, max_len=MAX_LEN, device="cpu")


def _prefilled(pipe, prompts):
    """Slot cache + first decode inputs from one batched prefill."""
    toks = np.asarray(prompts, np.int32)
    logits, ks, vs = pipe.prefill_prompt(toks)
    cache = pipe.init_slot_cache(max(N, toks.shape[0]))
    for l in range(pipe.cfg.layers):
        pipe.slot_write(cache[l]["k"], ks[l], 0)
        pipe.slot_write(cache[l]["v"], vs[l], 0)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)
    pos = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32)
    return cache, nxt, pos


def _ref_step(smoke, prompts):
    """Uncoded reference logits for the first post-prompt decode step."""
    cfg_r, params, _, _ = smoke
    toks = jnp.asarray(prompts)
    cache = ref_lm.init_cache(cfg_r, toks.shape[0], MAX_LEN, jnp.float32)
    logits, cache = ref_lm.prefill(params, cfg_r, cache, toks)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    ref, _ = ref_lm.decode_step(params, cfg_r, cache, nxt[:, None],
                                jnp.int32(toks.shape[1]))
    return np.asarray(ref[:, 0])


def _subsets(n, delta):
    return list(itertools.combinations(range(n), delta))


def test_weights_encoded_once_with_reference_values(smoke):
    cfg_r, params, cfg, _ = smoke
    pipe = _pipe(smoke)
    assert pipe.weight_encode_calls == 4 * cfg.layers
    ref = ref_build(cfg_r, params, N, k_b=4, bucket_sizes=(2, 4), max_len=MAX_LEN)
    eb = pipe.plan.ell_b
    for got, want in zip(pipe.coded_filters, ref.coded_filters):
        want = np.asarray(want)  # (n, ell_b, d_in, ob)
        n, _, d_in, ob = want.shape
        want = want.transpose(0, 2, 1, 3).reshape(n, d_in, eb * ob)
        _close(got, want, 1e-6)
    cache, nxt, pos = _prefilled(pipe, [PROMPT, PROMPT])
    for _ in range(3):
        _, nxt_, cache = pipe.run_decode_step_direct(nxt, cache, pos)
        nxt, pos = nxt_[:2], pos + 1
    # serving steps re-encodes nothing: weights are resident
    assert pipe.weight_encode_calls == 4 * cfg.layers


def test_prefill_prompt_matches_reference(smoke):
    cfg_r, params, _, _ = smoke
    pipe = _pipe(smoke)
    ref = ref_build(cfg_r, params, N, k_b=4, bucket_sizes=(2, 4), max_len=MAX_LEN)
    toks = np.asarray([PROMPT, PROMPT2], np.int32)
    got = pipe.prefill_prompt(toks)
    want = ref.prefill_prompt(jnp.asarray(toks))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_decode_parity_forced_subsets(smoke, backend):
    """Coded decode == the reference pipeline's and the uncoded decoder's
    output for EVERY survivor subset; greedy tokens exact."""
    cfg_r, params, _, _ = smoke
    pipe = _pipe(smoke, backend=backend)
    ref_pipe = ref_build(cfg_r, params, N, k_b=4, bucket_sizes=(2, 4),
                         max_len=MAX_LEN)
    prompts = [PROMPT, [3, 3, 4, 8, 2]]
    ref = _ref_step(smoke, prompts)
    cache, nxt, pos = _prefilled(pipe, prompts)
    rtoks = jnp.asarray(np.asarray([PROMPT, [3, 3, 4, 8, 2]], np.int32))
    rlog, rks, rvs = ref_pipe.prefill_prompt(rtoks)
    rcache = ref_pipe.init_slot_cache(N)
    for l in range(cfg_r.layers):
        rcache[l]["k"] = ref_pipe.slot_write(rcache[l]["k"], rks[l], 0)
        rcache[l]["v"] = ref_pipe.slot_write(rcache[l]["v"], rvs[l], 0)
    rnxt = jnp.argmax(rlog[:, -1], axis=-1).astype(jnp.int32)
    b = len(prompts)
    for ids in _subsets(N, pipe.specs[0].plan.delta):
        logits, toks, _ = pipe.run_decode_step_direct(nxt, cache, pos, worker_ids=ids)
        want, _, _ = ref_pipe.run_decode_step_direct(
            rnxt, rcache, jnp.asarray(pos.numpy()), worker_ids=ids)
        _close(logits[:b], want[:b])
        _close(logits[:b], ref)
        assert np.array_equal(toks[:b].numpy(), ref.argmax(-1)), (
            f"greedy token mismatch for subset {ids} ({backend})")


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_replication_bit_exact_vs_uncoded(smoke, backend):
    """k_b=1 replication decodes by multiplying with an exact 1.0, the
    uncoded plan by the identity — same worker program, same glue, so the
    fp32 outputs are bit-identical for every forced survivor."""
    rep = _pipe(smoke, backend=backend, k_b=1, n=3)
    unc = _pipe(smoke, backend=backend, plan=UncodedPlan(N))
    cache_r, nxt, pos = _prefilled(rep, [PROMPT, PROMPT2])
    cache_u, _, _ = _prefilled(unc, [PROMPT, PROMPT2])
    lu, tu, _ = unc.run_decode_step_direct(nxt, cache_u, pos)
    for wid in range(3):
        lr, tr, _ = rep.run_decode_step_direct(nxt, cache_r, pos, worker_ids=(wid,))
        assert torch.equal(lr, lu), f"survivor {wid} not bit-equal"
        assert torch.equal(tr, tu)


def test_uncoded_plan_needs_all_workers(smoke):
    unc = _pipe(smoke, plan=UncodedPlan(N))
    with pytest.raises(ValueError, match="needs delta"):
        unc.run_decode_step_direct(
            torch.zeros(2, dtype=torch.int32), unc.init_slot_cache(N),
            torch.zeros(2, dtype=torch.int32), worker_ids=(0, 1, 2))
    with pytest.raises(ValueError, match="needs all"):
        unc.decode_matrix(0, (0, 1, 3, 3))


def test_greedy_steps_match_reference_decoder(smoke):
    """Eight greedy steps on the direct path, a different survivor subset
    each step, against the uncoded reference decode loop."""
    cfg_r, params, _, _ = smoke
    pipe = _pipe(smoke)
    prompts = [PROMPT, PROMPT2]
    cache, nxt, pos = _prefilled(pipe, prompts)
    toks = jnp.asarray(prompts)
    rc = ref_lm.init_cache(cfg_r, 2, MAX_LEN, jnp.float32)
    rl, rc = ref_lm.prefill(params, cfg_r, rc, toks)
    rn = jnp.argmax(rl[:, -1], axis=-1).astype(jnp.int32)
    assert np.array_equal(nxt.numpy(), np.asarray(rn))
    subsets = _subsets(N, 2)
    for step in range(8):
        logits, nxt, cache = pipe.run_decode_step_direct(
            nxt, cache, pos, worker_ids=subsets[step % len(subsets)])
        rl, rc = ref_lm.decode_step(params, cfg_r, rc, rn[:, None],
                                    jnp.int32(len(PROMPT) + step))
        rn = jnp.argmax(rl[:, 0], axis=-1).astype(jnp.int32)
        _close(logits[:2], rl[:, 0])
        assert np.array_equal(nxt[:2].numpy(), np.asarray(rn)), f"step {step}"
        nxt, pos = nxt[:2], pos + 1


@pytest.mark.parametrize("mode", ["simulated", "threads"])
def test_cluster_straggler_skipped(smoke, mode):
    """1 of n straggling: every round decodes from the fastest delta, the
    straggler's results are never waited on, outputs match reference."""
    pipe = _pipe(smoke)
    st = StragglerModel(np.array([0.0, 0.0, 0.05, 0.0]))  # worker 2 straggles
    with FcdccCluster(pipe.specs[0].plan, st, mode=mode, device="cpu") as cluster:
        cluster.load_pipeline(pipe, "lm")
        prompts = [PROMPT, PROMPT2]
        ref = _ref_step(smoke, prompts)
        cache, nxt, pos = _prefilled(pipe, prompts)
        timings = []
        logits, toks, _ = pipe.run_decode_step_cluster(
            cluster, nxt, cache, pos, model="lm", timings=timings)
        _close(logits[:2], ref)
        assert np.array_equal(toks[:2].numpy(), ref.argmax(-1))
        assert len(timings) == 4 * pipe.cfg.layers
        assert all(2 not in t.used_workers for t in timings)


def test_cluster_dead_worker(smoke):
    """delay=inf worker: coded rounds decode from the survivors; the
    uncoded plan (delta=n) degrades instead."""
    st = StragglerModel(np.array([0.0, float("inf"), 0.0, 0.0]))  # worker 1 dead
    pipe = _pipe(smoke)
    with FcdccCluster(pipe.specs[0].plan, st, mode="threads", device="cpu") as cluster:
        cluster.load_pipeline(pipe, "lm")
        ref = _ref_step(smoke, [PROMPT])
        cache, nxt, pos = _prefilled(pipe, [PROMPT])
        logits, _, _ = pipe.run_decode_step_cluster(cluster, nxt, cache, pos,
                                                    model="lm")
        _close(logits[:1], ref)
        unc = _pipe(smoke, plan=UncodedPlan(N))
        cluster.load_pipeline(unc, "lm-uncoded")
        cache_u, nxt_u, pos_u = _prefilled(unc, [PROMPT])
        with pytest.raises(ClusterDegraded):
            unc.run_decode_step_cluster(cluster, nxt_u, cache_u, pos_u,
                                        model="lm-uncoded")


def test_program_count_bounded_over_buckets(smoke):
    """Distinct worker-program shape signatures stay within geometries x
    buckets on both paths; the survivor subset and the decode inverse are
    runtime arguments of ONE decode program."""
    pipe = _pipe(smoke, buckets=(1, 2, 4))
    assert pipe.num_geometries == 4  # qkv / wo / gateup / down
    assert pipe.program_trace_bound == 4 * 3
    with FcdccCluster(pipe.specs[0].plan, None, mode="simulated",
                      device="cpu") as cluster:
        cluster.load_pipeline(pipe, "lm")
        for bucket in (1, 2, 4):
            cache, nxt, pos = _prefilled(pipe, [PROMPT] * bucket)
            for ids in _subsets(N, 2)[:2]:
                pipe.run_decode_step_direct(nxt, cache, pos, worker_ids=ids)
            pipe.run_decode_step_cluster(cluster, nxt, cache, pos, model="lm")
    for cache in (pipe._batch_programs, pipe._cluster_programs):
        assert len(cache) == 1
        (prog,) = cache.values()
        assert len(prog.signatures) <= pipe.program_trace_bound
    assert pipe.worker_program_traces <= 2 * pipe.program_trace_bound
    assert pipe.decoder_fn(0) is pipe.decoder_fn(7)
    dms = [pipe.decode_matrix(0, ids) for ids in _subsets(N, 2)]
    assert len({dm.numpy().tobytes() for dm in dms}) > 1  # genuinely different
    assert pipe.decode_matrix(0, (0, 1)) is pipe.decode_matrix(5, (0, 1))


def test_rejects_what_coded_decode_does_not_take(smoke):
    _, _, cfg, port = smoke
    from repro_torch.core.fcdcc import FcdccPlan

    with pytest.raises(ValueError, match="k_a=1"):
        CodedDecoderPipeline(cfg, port, FcdccPlan(n=4, k_a=2, k_b=2), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        build_lm_decoder_pipeline(cfg, port, 4, k_b=6, device="cpu")
    with pytest.raises(ValueError, match="1..16"):  # K3's code-size limit
        build_lm_decoder_pipeline(cfg, port, 12, k_b=16, device="cpu")
    with pytest.raises(ValueError, match="need k_b or plan"):
        build_lm_decoder_pipeline(cfg, port, 4, device="cpu")
