"""The compiled steps of ``serve_lm`` and ``train`` (``launch/steps.py``:
the port's counterpart of the reference's ``jax.jit`` of the decode step,
the cache-filling prefill and the train step) on the CPU, for every arch
id at its smoke config.

The CPU has no CUDA graphs, so these tests capture with ``EmulatedGraph``
(``tests/_torch_graph_emulator.py``), which records the ops a capture runs
and replays them on the same tensors, and raises on a host sync.  Its
recording runs the ops, so a capture that wrote state in place without
restoring it would advance that state twice.

Weights are the reference's ``schema_init`` (norm gains non-zero) carried
across by ``params_from_numpy``; tokens are numpy-seeded.  A captured step
is held ``torch.equal`` to the eager step (the same ops on the same
values; a tensor position and an int give the same integers), and the
logits within 1e-4 of max|logit| of the reference's ``decode_fn``, as
``tests/test_torch_archs.py`` holds the eager step (fp32 sums in another
order); greedy tokens equal the reference's.

The cases themselves, shared by the files that run them, one an arch
family so that ``--dist loadfile`` spreads them over workers:
``test_torch_compiled_dense.py``, ``test_torch_compiled_moe.py``,
``test_torch_compiled_recurrent.py`` and ``test_torch_compiled_chip.py``
(``chip_smoke.py``'s captured phases rehearsed).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import close, reference_params
from _torch_graph_emulator import EmulatedGraph, _Record
from repro.configs import get_bundle as ref_get_bundle
from repro_torch.configs import ARCH_IDS, get_bundle
from repro_torch.core.graphs import GraphCaptureError, GraphSet
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as lm
from repro_torch.models.common import params_from_numpy
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
REL = 1e-4
B, P, GEN = 2, 6, 6
MAX_LEN = P + GEN
STEPS = 8  # decode positions replayed, past the prompt's length
SEED = 0

_SETUPS: dict = {}


def _setup(arch):
    """(reference bundle, its params, port bundle, port params, tokens
    (B, MAX_LEN)) of ``arch``'s smoke config, made once."""
    if arch not in _SETUPS:
        rb = ref_get_bundle(arch, smoke=True)
        p_np = reference_params(rb.schema, len(arch))
        pb = get_bundle(arch, smoke=True)
        toks = np.random.default_rng(len(arch)).integers(
            0, pb.cfg.vocab, (B, MAX_LEN)).astype(np.int32)
        _SETUPS[arch] = (rb, jax.tree.map(jnp.asarray, p_np), pb,
                         params_from_numpy(p_np, "cpu"), toks)
    return _SETUPS[arch]


def _graphs():
    return GraphSet("test", CPU, EmulatedGraph)


def _col(toks, t):
    return torch.as_tensor(toks[:, t:t + 1]).long()


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# -- the decode step --------------------------------------------------------
def captured_decode_equals_eager_and_reference(arch):
    """One graph replayed at STEPS positions: each step's logits
    ``torch.equal`` to the eager step's and within REL of the reference's,
    the cache (or recurrent state) ``torch.equal`` after every step."""
    rb, pr, pb, pp, toks = _setup(arch)
    gs = _graphs()
    decode = steps.compiled_decode(pb, gs, MAX_LEN, CPU)
    ce = pb.make_cache(B, MAX_LEN, device="cpu")
    cc = pb.make_cache(B, MAX_LEN, device="cpu")
    cr = rb.make_cache(B, MAX_LEN, jnp.float32)
    for t in range(STEPS):
        want, ce = pb.decode_fn(pp, ce, {"tokens": _col(toks, t), "pos": t})
        got = decode(pp, cc, _col(toks, t), t)
        assert torch.equal(got, want), (arch, t)
        assert _equal_trees(cc, ce), (arch, t)
        lr, cr = rb.decode_fn(pr, cr, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                       "pos": jnp.int32(t)})
        close(got.numpy(), lr, REL)
    assert gs.captures == {"decode": 1} and gs.replays == {"decode": STEPS}


def tensor_position_hits_no_host_sync(arch):
    """``decode_fn`` with the position as a 0-d tensor runs under the
    emulator's recorder (which raises on ``_local_scalar_dense``) and
    gives the int position's logits and cache, bit for bit."""
    _, _, pb, pp, toks = _setup(arch)
    ci = pb.make_cache(B, MAX_LEN, device="cpu")
    ct = pb.make_cache(B, MAX_LEN, device="cpu")
    for t in range(3):
        want, ci = pb.decode_fn(pp, ci, {"tokens": _col(toks, t), "pos": t})
        with _Record([]):
            got, ct = pb.decode_fn(pp, ct, {"tokens": _col(toks, t),
                                            "pos": torch.tensor(t)})
        assert torch.equal(got, want) and _equal_trees(ct, ci), (arch, t)


def position_past_the_cache_raises_before_any_replay(arch):
    _, _, pb, pp, toks = _setup(arch)
    gs = _graphs()
    decode = steps.compiled_decode(pb, gs, MAX_LEN, CPU)
    cache = pb.make_cache(B, MAX_LEN, device="cpu")
    decode(pp, cache, _col(toks, 0), 0)
    before = [c.clone() for c in tree_leaves(cache)]
    for pos in (MAX_LEN, -1):
        with pytest.raises(ValueError, match="outside the cache length"):
            decode(pp, cache, _col(toks, 1), pos)
    assert gs.replays == {"decode": 1}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), before))


def first_captured_step_advances_the_state_once(arch):
    """The recurrent state is written in place and read again: the first
    call (warm-up, capture, replay) leaves it as one eager step does."""
    _, _, pb, pp, toks = _setup(arch)
    decode = steps.compiled_decode(pb, _graphs(), MAX_LEN, CPU)
    ce = pb.make_cache(B, MAX_LEN, device="cpu")
    cc = pb.make_cache(B, MAX_LEN, device="cpu")
    pb.decode_fn(pp, ce, {"tokens": _col(toks, 0), "pos": 0})
    decode(pp, cc, _col(toks, 0), 0)
    assert _equal_trees(cc, ce)


# -- the prefill --------------------------------------------------------------
def captured_prefill_equals_eager(arch):
    """The prompt pass ``serve_lm`` runs, captured against eager, on two
    prompts in turn (the second a replay on tokens copied in, over a
    zeroed cache): ``prefill_cache_fn`` for the transformer family, the
    decode step stepped over the prompt for the others (no cache-filling
    prefill, as in the reference)."""
    _, _, pb, pp, toks = _setup(arch)
    gs = _graphs()
    cached = pb.prefill_cache_fn is not None
    assert cached == (pb.family in ("lm", "vlm"))
    prefill = steps.compiled_prefill(pb, gs)
    decode = steps.compiled_decode(pb, gs, MAX_LEN, CPU)
    cc = pb.make_cache(B, MAX_LEN, device="cpu")
    for prompt in (toks[:, :P], toks[:, P:]):
        ce = pb.make_cache(B, MAX_LEN, device="cpu")
        for leaf in tree_leaves(cc):
            leaf.zero_()
        tp = torch.as_tensor(prompt).long()
        if cached:
            want, ce = pb.prefill_cache_fn(pp, ce, {"tokens": tp})
            got = prefill(pp, cc, tp)
        else:
            for t in range(P):
                want, ce = pb.decode_fn(pp, ce, {"tokens": tp[:, t:t + 1],
                                                 "pos": t})
                got = decode(pp, cc, tp[:, t:t + 1], t)
        assert torch.equal(got, want) and _equal_trees(cc, ce), arch
    assert sum(gs.captures.values()) == 1


# -- serve_lm ---------------------------------------------------------------
def _reference_tokens(rb, pr, prompts: np.ndarray) -> np.ndarray:
    """The reference's greedy loop (``repro.launch.serve.serve_lm``) over
    ``prompts`` with the given params."""
    b, p = prompts.shape
    cache = rb.make_cache(b, p + GEN, jnp.float32)
    if rb.prefill_cache_fn is not None:
        logits, cache = rb.prefill_cache_fn(pr, cache,
                                            {"tokens": jnp.asarray(prompts)})
    else:
        for t in range(p):
            logits, cache = rb.decode_fn(
                pr, cache, {"tokens": jnp.asarray(prompts[:, t:t + 1]),
                            "pos": jnp.int32(t)})
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    out = []
    for t in range(p, p + GEN):
        out.append(tok)
        logits, cache = rb.decode_fn(pr, cache, {"tokens": tok,
                                                 "pos": jnp.int32(t)})
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return np.asarray(jnp.concatenate(out, axis=1))


def serve_lm_captured_equals_eager_and_reference(arch):
    """``serve_lm(graphs=EmulatedGraph)`` twice and ``graphs=False`` once
    from the same weights: every call's logits ``torch.equal``, its tokens
    the reference's greedy tokens; each captured call holds at most two
    graphs (prefill and decode), the decode graph replayed for every
    stepped prompt position and every new token."""
    rb, pr, pb, pp, _ = _setup(arch)
    runs = []
    for graphs in (False, EmulatedGraph, EmulatedGraph):
        logits, timings = [], {}
        toks = serve_mod.serve_lm(arch, batch=B, prompt_len=P, gen=GEN,
                                  smoke=True, seed=SEED, device="cpu",
                                  params=pp, graphs=graphs, timings=timings,
                                  on_logits=logits.append)
        runs.append((toks, logits, timings))
    (toks_e, logits_e, t_e) = runs[0]
    assert "graphs" not in t_e
    for toks, logits, timings in runs[1:]:
        assert torch.equal(toks, toks_e)
        assert len(logits) == len(logits_e)
        assert all(torch.equal(a, b) for a, b in zip(logits, logits_e))
        g = timings["graphs"]
        stepped = 0 if pb.prefill_cache_fn is not None else P
        assert sum(g["captures"].values()) <= 2
        assert g["captures"] == ({"decode": 1} if stepped else
                                 {"prefill": 1, "decode": 1})
        assert g["replays"]["decode"] == stepped + GEN
    prompts = torch.randint(0, pb.cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(SEED + 1))
    want = _reference_tokens(rb, pr, prompts.numpy().astype(np.int32))
    np.testing.assert_array_equal(toks_e.numpy(), want)


# -- the train step -----------------------------------------------------------
def _train_batches(pb, n, seq=16):
    data = SyntheticTokens(DataConfig(vocab=pb.cfg.vocab, seq_len=seq,
                                      global_batch=B))
    return [{k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            for i in range(n)]


def captured_train_steps_equal_eager(arch):
    """Three steps captured (params, moments and step count resident and
    written in place) against three eager steps from the same state:
    the losses and, from step 2 on (step 0's learning rate is 0),
    params, m, v and step ``torch.equal``.  At 2 x 16 tokens the CPU adds
    the embedding's gradient rows serially; past PyTorch's grain size
    (32,768 elements) it adds them in parallel with atomics, in no fixed
    order, eager or captured alike."""
    pb = get_bundle(arch, smoke=True)
    tcfg = steps.TrainConfig(opt=AdamWConfig(), warmup=2, total_steps=6)
    states = []
    for graphs in (None, _graphs()):
        params = pb.init(torch.Generator().manual_seed(SEED), torch.float32, "cpu")
        states.append((params, init_state(params),
                       steps.compiled_train_step(steps.build_train_step(pb, tcfg),
                                                 graphs), graphs))
    for i, batch in enumerate(_train_batches(pb, 3)):
        (pe, oe, fe, _), (pc, oc, fc, gs) = states
        _, _, me = fe(pe, oe, batch)
        _, _, mc = fc(pc, oc, batch)
        assert torch.equal(mc["loss"], me["loss"])
        assert torch.equal(mc["grad_norm"], me["grad_norm"])
        if i >= 2:
            assert _equal_trees(pc, pe)
            assert _equal_trees(oc, oe) and int(oc["step"]) == 3
    assert gs.captures == {"train_step": 1} and gs.replays == {"train_step": 3}


def captured_restart_is_bit_equal(tmp_path):
    """A captured ``train`` resumed from its checkpoint at step 3 gives the
    uninterrupted captured run's losses and final params bit for bit."""
    kw = dict(steps=6, batch=B, seq=16, smoke=True, ckpt_dir=str(tmp_path),
              ckpt_every=3, device="cpu", graphs=EmulatedGraph, log_every=100)
    losses = train_mod.train("smollm-135m", **kw)
    final = os.path.join(tmp_path, "step-00000006", "arrays.npz")
    with np.load(final) as f:
        want = {k: f[k] for k in f.files}
    for d in os.listdir(tmp_path):
        if d.startswith("step-") and int(d.split("-")[1]) > 3:
            os.rename(os.path.join(tmp_path, d),
                      os.path.join(tmp_path, "dropped-" + d))
    rest = train_mod.train("smollm-135m", **kw)
    assert rest == losses[3:]
    with np.load(final) as f:
        assert sorted(f.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(f[k], want[k], err_msg=k)


# -- no fallback ------------------------------------------------------------
def failed_capture_raises_from_serve_lm(monkeypatch):
    """A decode step that reads its position on the host cannot be
    captured: ``serve_lm`` raises ``GraphCaptureError`` and serves
    nothing eagerly instead."""
    real = lm.decode_step

    def synced(params, cfg, cache, tokens, pos):
        return real(params, cfg, cache, tokens, int(pos))

    monkeypatch.setattr(lm, "decode_step", synced)
    served = []
    with pytest.raises(GraphCaptureError, match="decode.*host sync"):
        serve_mod.serve_lm("smollm-135m", batch=B, prompt_len=P, gen=GEN,
                           smoke=True, device="cpu", graphs=EmulatedGraph,
                           on_logits=served.append)
    assert len(served) == 1  # the prefill's, captured; no decode step ran


def failed_capture_raises_from_train(monkeypatch):
    """A schedule that reads the step count on the host cannot be
    captured: ``train`` raises ``GraphCaptureError`` and takes no step."""
    real = steps.cosine_with_warmup

    def synced(step, **kw):
        return real(int(step), **kw)

    monkeypatch.setattr(steps, "cosine_with_warmup", synced)
    taken = []
    with pytest.raises(GraphCaptureError, match="train_step.*host sync"):
        train_mod.train("smollm-135m", steps=3, batch=B, seq=16, smoke=True,
                        device="cpu", graphs=EmulatedGraph,
                        on_step=lambda s, m: taken.append(s))
    assert taken == []


# -- chip_smoke.py's changed phases, rehearsed --------------------------------
def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels.coded_gemm.kernel import launches as k3
    from repro_torch.kernels.conv2d.kernel import launches as k1
    from repro_torch.kernels.flash_attn.kernel import launches as k4
    from repro_torch.kernels.matmul.kernel import launches as k2
    return cs, (k1, k2, k3, k4)


def chip_smoke_training_phase_rehearses_captured_on_the_cpu(capsys):
    """``chip_smoke.py``'s training phase at the smoke config, captured
    with the emulator and eagerly, cut to 10 steps of 2 x 32 tokens (the
    card runs 30 of 8 x 256): the captured run within its limits of the
    eager one, the captured restart held, the lines printed."""
    cs, counters = _chip_smoke()
    cs.TRAIN_STEPS, cs.TRAIN_CKPT, cs.TRAIN_BATCH, cs.TRAIN_SEQ = 10, 5, 2, 32
    tr = cs.train_phase(CPU, counters, "cpu", smoke=True, graphs=EmulatedGraph)
    cs.print_train(tr, "cpu")
    assert max(tr["captured_vs_eager"].values()) <= cs.TOL_TRAIN_GRAPH
    assert tr["restart_rel_err"] <= cs.TOL_TRAIN_RESTART
    assert "captured against eager: losses of steps 1-10" in capsys.readouterr().out


def chip_smoke_zoo_phase_rehearses_captured_on_the_cpu(capsys):
    """``chip_smoke.py``'s arch-zoo phase at the smoke configs, each arch
    served captured (the emulator) and eagerly: logits equal, the
    transformer family's prefill and decode captured, the others'
    decode, every prefill and decode call compared."""
    cs, counters = _chip_smoke()
    zoo = cs.zoo_phase(CPU, counters, "cpu", smoke=True, graphs=EmulatedGraph)
    assert [z["arch"] for z in zoo["archs"]] == [a for a, _ in cs.ZOO]
    for z in zoo["archs"]:
        cached = z["family"] in ("lm", "vlm")
        assert zoo["graphs"][z["arch"]]["captures"] == (
            {"prefill": 1, "decode": 1} if cached else {"decode": 1})
        assert z["logits_calls_equal"] == (1 if cached else cs.ZOO_PROMPT) + cs.ZOO_GEN
    out = capsys.readouterr().out
    assert out.count("serve_lm captured against eager: tokens equal") == len(cs.ZOO)
