"""The port's continuous-batching coded LM server (``serving/lm_engine.py``)
against the reference's greedy decoder, on smollm-135m-smoke with the
reference's weights carried across as numpy.

Covers: token-stream continuous batching with late admission per decode
step (every request's tokens equal the uncoded reference decoder's
exactly, as exp13 demands, whatever admission order interleaved them);
slot compaction with padded prompts; single-token requests completing at
admission; a straggler and a dead worker on the threads pool; the direct
path with a forced survivor subset; request packing; lifecycle guards; and
CNN + LM co-serving on ONE port cluster.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as ref_smollm
from repro.models import transformer as ref_lm
from repro_torch.configs import smollm_135m
from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
from repro_torch.core.pipeline import build_cnn_pipeline
from repro_torch.models import transformer as lm
from repro_torch.models.cnn import init_cnn, input_hw
from repro_torch.runtime import FcdccCluster, StragglerModel
from repro_torch.serving import CodedLMServer, pack_request, unpack_request

N = 4
MAX_LEN = 32
MAX_PROMPT = 8
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 4, 8, 2], [11], [6, 2, 9, 1]]
GENS = [6, 4, 3, 1, 5]


@pytest.fixture(scope="module")
def smoke():
    bundle = ref_smollm.smoke()
    params = bundle.init(jax.random.PRNGKey(0), jnp.float32)
    port = lm.lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return bundle.cfg, params, smollm_135m.smoke(), port


def _ref_generate(smoke, prompt, gen, rows=None):
    """Uncoded greedy reference: batched prefill + decode_step loop.  With
    ``rows`` a list, appends the logits row each token was chosen from."""
    cfg_r, params, _, _ = smoke
    toks = jnp.asarray([prompt])
    cache = ref_lm.init_cache(cfg_r, 1, MAX_LEN, jnp.float32)
    logits, cache = ref_lm.prefill(params, cfg_r, cache, toks)
    row = logits[0, len(prompt) - 1]
    out = [int(jnp.argmax(row))]
    pos = len(prompt)
    for _ in range(gen - 1):
        if rows is not None:
            rows.append(np.asarray(row))
        logits, cache = ref_lm.decode_step(
            params, cfg_r, cache, jnp.asarray([[out[-1]]], jnp.int32),
            jnp.int32(pos))
        row = logits[0, 0]
        out.append(int(jnp.argmax(row)))
        pos += 1
    if rows is not None:
        rows.append(np.asarray(row))
    return out


@pytest.fixture(scope="module")
def refs(smoke):
    return [_ref_generate(smoke, p, g) for p, g in zip(PROMPTS, GENS)]


def _pipe(smoke, **kw):
    _, _, cfg, port = smoke
    kw.setdefault("bucket_sizes", (1, 2, 4))
    kw.setdefault("max_len", MAX_LEN)
    return build_lm_decoder_pipeline(cfg, port, N, k_b=4, device="cpu", **kw)


def test_pack_unpack_roundtrip():
    row = pack_request([4, 5, 6], 7, MAX_PROMPT)
    prompt, gen = unpack_request(row)
    assert prompt.tolist() == [4, 5, 6] and gen == 7
    with pytest.raises(ValueError, match="exceeds"):
        pack_request(list(range(MAX_PROMPT + 1)), 1, MAX_PROMPT)
    with pytest.raises(ValueError, match="at least one"):
        pack_request([], 1, MAX_PROMPT)
    with pytest.raises(ValueError, match="max_new_tokens"):
        pack_request([1], 0, MAX_PROMPT)


def test_continuous_batching_matches_reference(smoke, refs):
    """Mixed prompt/generation lengths served concurrently, plus a request
    submitted mid-flight (admitted at a decode-step boundary), all match
    the uncoded reference decoder exactly."""
    srv = CodedLMServer(_pipe(smoke), max_prompt=MAX_PROMPT, poll_interval_s=0.002)
    with srv:
        handles = [srv.submit(p, g) for p, g in zip(PROMPTS, GENS)]
        time.sleep(0.05)  # engine mid-stream: this one admits late
        late = srv.submit([2, 4, 6], 4)
        results = [h.result(timeout=120) for h in handles]
        late_result = late.result(timeout=120)
    for got, want in zip(results, refs):
        assert list(got) == want
    assert list(late_result) == _ref_generate(smoke, [2, 4, 6], 4)
    assert srv.requests_served == len(PROMPTS) + 1
    assert srv.tokens_generated >= sum(GENS) + 4
    assert srv.tokens_per_second() > 0
    assert srv.decode_steps > 0 and srv.rounds == 4 * 2 * srv.decode_steps


def test_served_logits_match_reference(smoke, refs):
    """``on_logits`` hands over the very rows the served tokens were chosen
    from — through late admission and compaction — and each request's rows
    equal the reference decoder's teacher-forced logits (1e-4 relative to
    max|logit|, the coded decoder's tolerance)."""
    got: dict[int, list] = {}
    srv = CodedLMServer(
        _pipe(smoke), max_prompt=MAX_PROMPT, poll_interval_s=0.002,
        on_logits=lambda rid, row: got.setdefault(rid, []).append(row.clone()))
    with srv:
        handles = [srv.submit(p, g) for p, g in zip(PROMPTS, GENS)]
        results = [h.result(timeout=120) for h in handles]
    for h, p, g, toks, want in zip(handles, PROMPTS, GENS, results, refs):
        assert list(toks) == want
        rows = got[h.request_id]
        assert len(rows) == g
        assert [int(r.argmax()) for r in rows] == list(toks)
        ref_rows: list = []
        _ref_generate(smoke, p, g, ref_rows)
        served = torch.stack(rows).numpy()
        ref = np.stack(ref_rows)
        scale = float(np.abs(ref).max())
        assert float(np.abs(served - ref).max()) <= 1e-4 * scale


def test_compaction_keeps_padded_prompt_garbage_hidden(smoke):
    """Eight requests through four slots: short prompts padded to
    max_prompt leave pad-token K/V beyond plen, requests finish out of
    order and compaction moves slot rows down — every stream still equals
    its solo reference."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, int(rng.integers(1, MAX_PROMPT + 1))).tolist()
               for _ in range(8)]
    gens = [int(g) for g in rng.integers(1, 7, 8)]
    srv = CodedLMServer(_pipe(smoke), max_prompt=MAX_PROMPT, poll_interval_s=0.002)
    with srv:
        handles = [srv.submit(p, g) for p, g in zip(prompts, gens)]
        results = [h.result(timeout=120) for h in handles]
    for p, g, got in zip(prompts, gens, results):
        assert list(got) == _ref_generate(smoke, p, g), (p, g)


def test_single_token_request(smoke, refs):
    """gen=1 resolves from the prefill logits alone — no decode round."""
    srv = CodedLMServer(_pipe(smoke), max_prompt=MAX_PROMPT)
    with srv:
        out = srv.generate(PROMPTS[3], 1)
    assert list(out) == refs[3]
    assert srv.decode_steps == 0


@pytest.mark.parametrize("mode", ["simulated", "threads"])
def test_straggler_and_dead_worker_serving(smoke, refs, mode):
    """Worker 2 straggling and worker 3 dead (within gamma=2): served
    tokens are unchanged."""
    st = StragglerModel(np.array([0.0, 0.0, 0.02, np.inf]))
    srv = CodedLMServer(_pipe(smoke), st, mode=mode, max_prompt=MAX_PROMPT)
    with srv:
        handles = [srv.submit(p, g) for p, g in zip(PROMPTS, GENS)]
        results = [h.result(timeout=120) for h in handles]
    for got, want in zip(results, refs):
        assert list(got) == want


def test_direct_execution_forced_subset(smoke, refs):
    """execution='direct' with a forced survivor subset: no cluster spun
    up, same tokens."""
    srv = CodedLMServer(_pipe(smoke), execution="direct", worker_ids=(1, 3),
                        max_prompt=MAX_PROMPT)
    assert srv.cluster is None
    with srv:
        out = srv.generate(PROMPTS[0], GENS[0])
    assert list(out) == refs[0]


def test_lifecycle_guards(smoke):
    srv = CodedLMServer(_pipe(smoke), max_prompt=MAX_PROMPT)
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit([1, 2], 2)
    with srv:
        with pytest.raises(ValueError, match="exceeds"):
            srv.submit(list(range(MAX_PROMPT + 1)), 2)
        with pytest.raises(RuntimeError, match="already started"):
            srv.start()
    srv.shutdown()  # idempotent
    with pytest.raises(ValueError, match="max_prompt"):
        CodedLMServer(_pipe(smoke), max_prompt=MAX_LEN)
    with pytest.raises(ValueError, match="bucket_sizes"):
        CodedLMServer(_pipe(smoke, bucket_sizes=None), max_prompt=MAX_PROMPT)
    with pytest.raises(ValueError, match="execution"):
        CodedLMServer(_pipe(smoke), execution="remote")


def test_shutdown_drain_finishes_requests(smoke, refs):
    """shutdown(drain=True) completes queued work before stopping."""
    srv = CodedLMServer(_pipe(smoke), max_prompt=MAX_PROMPT)
    srv.start()
    h = srv.submit(PROMPTS[0], GENS[0])
    srv.shutdown(drain=True)
    assert list(h.result(timeout=1)) == refs[0]


def test_cnn_lm_co_serving_one_pool(smoke, refs):
    """One port ``FcdccCluster`` serves a CNN's ConvL rounds and the LM's
    decoder GEMM rounds concurrently: the LM engine thread streams decode
    steps while another thread pushes CNN inferences through the same
    worker pool, and both outputs are unchanged from solo runs."""
    cnn_params = init_cnn("lenet5", torch.Generator().manual_seed(1), "cpu")
    cnn_pipe = build_cnn_pipeline(
        "lenet5", cnn_params, N, default_kab=(1, 2),
        input_hw=input_hw("lenet5", smoke=True), bucket_sizes=(1, 2),
        device="cpu")
    with FcdccCluster(cnn_pipe.specs[0].plan, None, mode="threads",
                      device="cpu") as cluster:
        cluster.load_pipeline(cnn_pipe, "cnn")
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(2,) + cnn_pipe.input_shape).astype(np.float32))
        y_solo, _ = cluster.run_pipeline(x, model="cnn")
        srv = CodedLMServer(_pipe(smoke), cluster=cluster, model="lm",
                            max_prompt=MAX_PROMPT)
        cnn_out, cnn_err = [], []

        def cnn_client():
            try:
                for _ in range(4):
                    y, _ = cluster.run_pipeline(x, model="cnn")
                    cnn_out.append(y)
            except Exception as err:  # surfaces in the main thread below
                cnn_err.append(err)

        with srv:
            t = threading.Thread(target=cnn_client)
            t.start()
            handles = [srv.submit(p, g) for p, g in zip(PROMPTS, GENS)]
            results = [h.result(timeout=120) for h in handles]
            t.join(timeout=120)
        assert not t.is_alive() and not cnn_err, f"CNN client failed: {cnn_err}"
        assert sorted(cluster.pipelines) == ["cnn", "lm"]
    for got, want in zip(results, refs):
        assert list(got) == want
    assert len(cnn_out) == 4
    for y in cnn_out:
        assert torch.equal(y, y_solo)
