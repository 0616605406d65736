"""The coded LM server's captured prefill (``CodedDecoderPipeline
.prefill_program``: the reference's jitted full-stack prefill,
``src/repro/core/decoder_pipeline.py``) on the CPU.

The CPU has no CUDA graphs, so these tests capture with ``EmulatedGraph``
(``tests/_torch_graph_emulator.py``), which records the ops a capture runs
and replays them on the same tensors; its recording runs the ops, as a
warm-up call does on the card.  A replayed prefill is held
``torch.equal`` to the eager one (the same ops on the same values), its
first tokens equal, and the served tokens to the reference's greedy
decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_graph_emulator import EmulatedGraph
from repro.configs import smollm_135m as ref_smollm
from repro.models import transformer as ref_lm
from repro_torch.configs import smollm_135m
from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
from repro_torch.models import transformer as lm
from repro_torch.serving import CodedLMServer

BUCKETS = (1, 2, 4)
MAX_LEN = 32
MAX_PROMPT = 8
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 4, 8, 2], [11], [6, 2, 9, 4, 1, 1, 7, 3]]
GENS = [5, 3, 6, 2, 4]


@pytest.fixture(scope="module")
def lm_ref():
    """The smoke SmolLM's reference params (norm gains drawn), carried
    across, and the reference's greedy tokens for ``PROMPTS``."""
    bundle = ref_smollm.smoke()
    params = bundle.init(jax.random.PRNGKey(0), jnp.float32)
    port = lm.lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    want = []
    for prompt, gen in zip(PROMPTS, GENS):
        cache = ref_lm.init_cache(bundle.cfg, 1, MAX_LEN, jnp.float32)
        logits, cache = ref_lm.prefill(params, bundle.cfg, cache,
                                       jnp.asarray([prompt]))
        toks = [int(jnp.argmax(logits[0, -1]))]
        for j in range(gen - 1):
            step, cache = ref_lm.decode_step(
                params, bundle.cfg, cache, jnp.asarray([[toks[-1]]], jnp.int32),
                jnp.int32(len(prompt) + j))
            toks.append(int(jnp.argmax(step[0, -1])))
        want.append(toks)
    return port, want


def _pipe(port, graphs):
    return build_lm_decoder_pipeline(smollm_135m.smoke(), port, 4, k_b=4,
                                     bucket_sizes=BUCKETS, max_len=MAX_LEN,
                                     device="cpu", graphs=graphs)


def _prompts(g, p, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (g, p)).astype(np.int32)


def _copy(out):
    return tuple(t.clone() for t in out)


def test_prefill_replay_equals_eager_one_graph_a_bucket(lm_ref):
    """Each bucket's prefill captured once and replayed: logits, K and V
    ``torch.equal`` to the eager pipeline's, first tokens equal; a second
    call of a bucket replays without capturing again."""
    port, _ = lm_ref
    pipe, eager = _pipe(port, EmulatedGraph), _pipe(port, False)
    for seed in (0, 1):
        for g in BUCKETS:
            toks = _prompts(g, MAX_PROMPT, seed)
            got, want = _copy(pipe.prefill_prompt(toks)), \
                _copy(eager.prefill_prompt(toks))
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert torch.equal(got[0][:, -1].argmax(-1), want[0][:, -1].argmax(-1))
    master = pipe.master_graphs
    assert master.captures["prefill"] == len(BUCKETS)
    assert master.replays["prefill"] == 2 * len(BUCKETS)
    assert eager.master_graphs is None


def test_prefill_returns_its_scratch_and_fresh_logits(lm_ref):
    """ks/vs are the bucket's resident scratch cache (the next prefill of
    the bucket overwrites them); the logits are the caller's own."""
    port, _ = lm_ref
    pipe = _pipe(port, EmulatedGraph)
    logits, ks, vs = pipe.prefill_prompt(_prompts(2, MAX_PROMPT))
    k, v = pipe.prefill_cache(2)
    assert ks is k and vs is v
    before = logits.clone()
    pipe.prefill_prompt(_prompts(2, MAX_PROMPT, seed=1))
    assert torch.equal(logits, before)


def test_prefill_scratch_cleared_between_prompt_widths(lm_ref):
    """The scratch is cleared inside the graph: a narrower prompt after a
    wider one on the same bucket, and a call after the scratch was
    poisoned with NaN, give the eager pass's fresh-cache K/V (zeros past
    the prompt)."""
    port, _ = lm_ref
    pipe, eager = _pipe(port, EmulatedGraph), _pipe(port, False)
    pipe.prefill_prompt(_prompts(2, MAX_PROMPT))
    for width in (3, MAX_PROMPT):
        toks = _prompts(2, width, seed=width)
        _, ks, vs = pipe.prefill_prompt(toks)
        _, eks, evs = eager.prefill_prompt(toks)
        assert torch.equal(ks, eks) and torch.equal(vs, evs)
        assert not bool(ks[:, :, width:].any())
        for t in pipe.prefill_cache(2):
            t.fill_(float("nan"))
    _, ks, _ = pipe.prefill_prompt(_prompts(2, MAX_PROMPT, seed=MAX_PROMPT))
    assert torch.equal(ks, eager.prefill_prompt(
        _prompts(2, MAX_PROMPT, seed=MAX_PROMPT))[1])
    assert pipe.master_graphs.captures["prefill"] == 2  # one a width


class _ReplaySpy(EmulatedGraph):
    """The emulator, noting the state of ``watch`` as each replay starts."""

    watch: torch.Tensor | None = None
    seen: list = []

    def replay(self):
        type(self).seen.append(type(self).watch.clone())
        super().replay()


@pytest.mark.parametrize("declared", [True, False])
def test_prefill_capture_restores_its_scratch(lm_ref, declared):
    """The prefill declares its scratch written (``Program(writes=)``): the
    capture restores it after the warm-up's real run and after the
    capture, so the replay that follows the capture starts from the
    scratch as the caller left it.  Without the declaration it would
    start from the capture's own writes (the undeclared case shows the
    check tells them apart)."""
    port, _ = lm_ref
    pipe = _pipe(port, _ReplaySpy)
    prog = pipe.prefill_program()
    assert prog.writes == (1, 2)
    if not declared:
        prog.writes = ()
    k, _ = pipe.prefill_cache(2)
    k.fill_(7.0)
    _ReplaySpy.watch, _ReplaySpy.seen = k, []
    pipe.prefill_prompt(_prompts(2, MAX_PROMPT))
    restored = bool((_ReplaySpy.seen[0] == 7.0).all())
    assert restored == declared


def test_served_prefill_captured_in_warmup_only(lm_ref):
    """The server's warmup captures one prefill graph a bucket (counted by
    ``glue_graph_bound``); serving replays them and captures nothing;
    tokens equal the eager server's and the reference's, and every served
    logits row is ``torch.equal`` to the eager server's."""
    port, want = lm_ref
    runs = {}
    for graphs in (EmulatedGraph, False):
        pipe = _pipe(port, graphs)
        rows = {}
        srv = CodedLMServer(
            pipe, execution="direct", max_prompt=MAX_PROMPT,
            poll_interval_s=0.002,
            on_logits=lambda rid, row, rows=rows: rows.setdefault(
                rid, []).append(row.clone()))
        srv.warmup()
        warm = (None if pipe.master_graphs is None
                else dict(pipe.master_graphs.captures))
        with srv:
            with srv.scheduler.not_empty:
                handles = [srv.submit(p, g) for p, g in zip(PROMPTS, GENS)]
            toks = [list(h.result(timeout=300)) for h in handles]
        runs[graphs] = (toks, [torch.stack(rows[h.request_id]) for h in handles])
        if graphs is not False:
            master = pipe.master_graphs
            assert warm["prefill"] == len(BUCKETS)
            assert master.captures == warm  # nothing captured while serving
            assert master.num_graphs <= pipe.glue_graph_bound
            assert master.replays["prefill"] >= 1 + len(BUCKETS)
            assert srv.prefill_warmup_s > 0
    assert runs[EmulatedGraph][0] == runs[False][0] == want
    for r, e in zip(runs[EmulatedGraph][1], runs[False][1]):
        assert torch.equal(r, e)


def test_set_graphs_false_prefills_eagerly(lm_ref):
    """``set_graphs(False)`` prefills op by op (no capture, no replay) and
    gives the captured pass's values; switching back replays the graph
    captured before."""
    port, _ = lm_ref
    pipe = _pipe(port, EmulatedGraph)
    toks = _prompts(4, MAX_PROMPT)
    captured = _copy(pipe.prefill_prompt(toks))
    master = pipe.master_graphs
    pipe.set_graphs(False)
    assert pipe.master_graphs is None and pipe.prefill_program().graphs is None
    for a, b in zip(_copy(pipe.prefill_prompt(toks)), captured):
        assert torch.equal(a, b)
    assert master.replays["prefill"] == 1
    pipe.set_graphs(EmulatedGraph)
    pipe.prefill_prompt(toks)
    assert master.captures["prefill"] == 1 and master.replays["prefill"] == 2
