"""The port's JSON/HTTP front-end (``serving/frontend.py``) on the CPU.

Mirrors the front-end cases of ``tests/test_serving.py``: a round trip for
two models and a graceful drain, per-item errors of the batched form, 503
with no model registered, 400 when the model is ambiguous.  Replies are
held against the reference's ``CodedPipeline`` on the same numpy inputs
and weights, to 1e-5 relative and absolute (fp32 sums in another order;
a served round may decode from another survivor subset than the
reference's default one, and any subset decodes the same function).
"""
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.pipeline import CodedPipeline as RefPipeline
from repro.core.pipeline import plan_layers as ref_plan_layers
from repro.models import cnn as ref_cnn
from repro_torch.core.pipeline import CodedPipeline, plan_layers
from repro_torch.models import cnn
from repro_torch.runtime import StragglerModel
from repro_torch.serving import CodedServer, ServingFrontend

RNG = np.random.default_rng(0)
TOL = dict(rtol=1e-5, atol=1e-5)
N, HW = 6, 12
STACK = [cnn.ConvL("s1", 2, 8, 3, padding=1, pool=2),
         cnn.ConvL("s2", 8, 8, 3, padding=1)]
REF_STACK = [ref_cnn.ConvL("s1", 2, 8, 3, padding=1, pool=2),
             ref_cnn.ConvL("s2", 8, 8, 3, padding=1)]
# a second model: the same layer names, other channels
STACK_B = [cnn.ConvL("s1", 3, 8, 3, padding=1, pool=2),
           cnn.ConvL("s2", 8, 4, 3, padding=1)]


def _params(layers, seed=0):
    rng = np.random.default_rng(seed)
    return {l.name: (rng.standard_normal((l.out_ch, l.in_ch, l.kernel, l.kernel))
                     * (l.in_ch * l.kernel**2) ** -0.5).astype(np.float32)
            for l in layers}


def _pipeline(layers=STACK, seed=0, kab=(2, 4)):
    return CodedPipeline(plan_layers(layers, HW, N, default_kab=kab),
                         _params(layers, seed), bucket_sizes=(1, 2, 4),
                         device="cpu")


def _reference():
    return RefPipeline(ref_plan_layers(REF_STACK, HW, N, default_kab=(2, 4)),
                       {k: jnp.asarray(v) for k, v in _params(STACK).items()})


def _images(count, c=2):
    return [RNG.standard_normal((c, HW, HW)).astype(np.float32)
            for _ in range(count)]


def _http(method, url, payload=None, timeout=30.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("mode,pool", [("simulated", None), ("threads", "device")])
def test_http_frontend_roundtrip_and_drain(mode, pool):
    """POST /v1/infer for two models on an ephemeral port, stats/models
    introspection, error codes, then a graceful drain: no engine thread
    left, pools released, socket closed."""
    server = CodedServer(straggler=StragglerModel.none(N), mode=mode, pool=pool)
    server.register_model("a", _pipeline())
    server.register_model("b", _pipeline(STACK_B, seed=3, kab=(4, 2)))
    ref_a = _reference()
    frontend = ServingFrontend(server, port=0)
    frontend.start()
    url = frontend.url
    try:
        status, models = _http("GET", f"{url}/v1/models")
        assert status == 200
        assert {m["name"] for m in models["models"]} == {"a", "b"}
        shapes = {m["name"]: tuple(m["input_shape"]) for m in models["models"]}
        assert shapes == {"a": (2, 12, 12), "b": (3, 12, 12)}
        assert {m["dtype"] for m in models["models"]} == {"float32"}
        assert all(m["bucket_sizes"] == [1, 2, 4] for m in models["models"])

        x = _images(1)[0]
        status, out = _http("POST", f"{url}/v1/infer",
                            {"model": "a", "input": x.tolist()})
        assert status == 200 and out["model"] == "a"
        np.testing.assert_allclose(np.asarray(out["output"], np.float32),
                                   np.asarray(ref_a.run(jnp.asarray(x))), **TOL)
        xb = _images(1, c=3)[0]
        status, out_b = _http("POST", f"{url}/v1/infer",
                              {"model": "b", "input": xb.tolist()})
        assert status == 200 and out_b["shape"][0] == 4  # STACK_B out_ch

        status, stats = _http("GET", f"{url}/v1/stats")
        assert status == 200
        assert stats["aggregate"]["completed"] == 2
        assert stats["per_model"]["a"]["completed"] == 1
        assert stats["per_model"]["b"]["completed"] == 1
        assert "overlap" in stats["aggregate"]

        for body, code in ((
                {"model": "nope", "input": x.tolist()}, 404),
                ({"model": "a", "input": [[1.0]]}, 400),
                ({"input": x.tolist()}, 400),  # ambiguous on two models
                (42, 400)):                    # valid JSON, not an object
            with pytest.raises(urllib.error.HTTPError) as err:
                _http("POST", f"{url}/v1/infer", body)
            assert err.value.code == code
        for method, path in (("GET", "/v1/nothing"), ("POST", "/v1/other")):
            with pytest.raises(urllib.error.HTTPError) as err:
                _http(method, f"{url}{path}", {} if method == "POST" else None)
            assert err.value.code == 404
    finally:
        frontend.shutdown()
    # graceful drain: engine thread joined, worker pools released, port dead
    assert server._thread is None
    assert server.cluster._pools is None
    assert not any(t.name == "coded-server-engine" and t.is_alive()
                   for t in threading.enumerate())
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _http("GET", f"{url}/v1/models", timeout=2.0)
    frontend.shutdown()  # idempotent


def test_http_batched_infer_per_item_errors():
    """POST /v1/infer with "inputs": one round trip fans out every image
    (in-order results), and a bad item yields a per-item error without
    failing its siblings."""
    server = CodedServer(_pipeline(), mode="simulated", model="a")
    ref_a = _reference()
    frontend = ServingFrontend(server, port=0)
    frontend.start()
    url = frontend.url
    try:
        xs = _images(3)
        status, out = _http("POST", f"{url}/v1/infer",
                            {"model": "a", "inputs": [x.tolist() for x in xs]})
        assert status == 200 and out["model"] == "a" and out["count"] == 3
        for x, item in zip(xs, out["results"]):
            assert "error" not in item
            np.testing.assert_allclose(np.asarray(item["output"], np.float32),
                                       np.asarray(ref_a.run(jnp.asarray(x))),
                                       **TOL)
        ids = [r["request_id"] for r in out["results"]]
        assert ids == sorted(ids)

        bad = [xs[0].tolist(), np.zeros((1, 2, 2)).tolist(), xs[2].tolist()]
        status, out = _http("POST", f"{url}/v1/infer",
                            {"model": "a", "inputs": bad})
        assert status == 200 and out["count"] == 3
        assert "error" not in out["results"][0]
        assert "request shape" in out["results"][1]["error"]
        assert "error" not in out["results"][2]

        for body in ({"model": "a", "inputs": []},
                     {"model": "a", "inputs": 5},
                     {"model": "a", "input": xs[0].tolist(),
                      "inputs": [xs[0].tolist()]}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _http("POST", f"{url}/v1/infer", body)
            assert err.value.code == 400
    finally:
        frontend.shutdown()


def test_http_infer_no_model_registered_is_503_not_crash():
    server = CodedServer(mode="simulated")
    frontend = ServingFrontend(server, port=0, manage_server=False)
    frontend.start()
    try:
        x = np.zeros((2, 12, 12)).tolist()
        for body in ({"input": x}, {"inputs": [x]}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _http("POST", f"{frontend.url}/v1/infer", body)
            assert err.value.code == 503
    finally:
        frontend.shutdown()


def test_http_engine_not_running_is_503():
    """A registered model behind an engine that was never started (the
    front-end does not manage it) answers 503 in both forms."""
    server = CodedServer(_pipeline(), mode="simulated", model="a")
    frontend = ServingFrontend(server, port=0, manage_server=False)
    frontend.start()
    try:
        x = _images(1)[0].tolist()
        for body in ({"input": x}, {"inputs": [x]}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _http("POST", f"{frontend.url}/v1/infer", body)
            assert err.value.code == 503
    finally:
        frontend.shutdown()


def test_http_batched_infer_requires_model_when_ambiguous():
    server = CodedServer(mode="simulated")
    server.register_model("a", _pipeline())
    server.register_model("b", _pipeline(STACK_B, seed=3, kab=(4, 2)))
    frontend = ServingFrontend(server, port=0)
    frontend.start()
    try:
        x = _images(1)[0]
        with pytest.raises(urllib.error.HTTPError) as err:
            _http("POST", f"{frontend.url}/v1/infer", {"inputs": [x.tolist()]})
        assert err.value.code == 400
        status, out = _http("POST", f"{frontend.url}/v1/infer",
                            {"model": "a", "inputs": [x.tolist()]})
        assert status == 200 and out["count"] == 1
    finally:
        frontend.shutdown()


def test_wait_many_times_out_without_cancelling():
    """``wait_many`` returns False at its timeout and cancels nothing; the
    same handles complete later."""
    server = CodedServer(_pipeline(), StragglerModel(np.array(
        [0.3] * N)), mode="threads", model="a")
    with server:
        handles = server.submit_many(_images(2))
        assert server.wait_many(handles, timeout=0.01) is False
        assert server.wait_many(handles, timeout=60.0) is True
        assert all(h.done() for h in handles)
    assert server.model_names() == ["a"]


def test_http_result_timeout_is_504_and_per_item_timeout():
    """A result that does not arrive within ``result_timeout_s`` answers
    504 in the single form and a per-item TimeoutError in the batched
    form; the request itself is not cancelled."""
    server = CodedServer(_pipeline(), StragglerModel(np.array([0.3] * N)),
                         mode="threads", model="a")
    frontend = ServingFrontend(server, port=0, result_timeout_s=0.02)
    frontend.start()
    try:
        x = _images(1)[0].tolist()
        with pytest.raises(urllib.error.HTTPError) as err:
            _http("POST", f"{frontend.url}/v1/infer", {"input": x})
        assert err.value.code == 504
        status, out = _http("POST", f"{frontend.url}/v1/infer", {"inputs": [x]})
        assert status == 200
        assert "TimeoutError" in out["results"][0]["error"]
    finally:
        frontend.shutdown()
    assert server.stats().completed == 2  # both finished after the replies
