"""HTTP serving endpoint: concurrent clients micro-batch through one
Engine.generate wave; responses carry tokens + usage; errors are 4xx."""

import json
import threading
import urllib.request

import jax
import pytest

from xbitops.engine.engine import Engine
from xbitops.engine.server import ServingEndpoint
from xbitops.models import llama

CFG = llama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def endpoint():
    params = llama.init_params(jax.random.PRNGKey(0), CFG, bits=4,
                               group_size=32)
    eng = Engine(params, CFG, slots=2, prefill_buckets=[8])
    ep = ServingEndpoint(eng, port=0, batch_window_s=0.05)
    ep.start()
    yield ep
    ep.shutdown()


def _post(port, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(endpoint):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{endpoint.port}/health", timeout=30) as r:
        body = json.loads(r.read())
    assert r.status == 200 and body["status"] == "ok"
    assert body["slots"] == 2


def test_completion_matches_engine(endpoint):
    code, body = _post(endpoint.port, {"prompt": [5, 9, 2], "max_tokens": 4})
    assert code == 200, body
    choice = body["choices"][0]
    assert len(choice["tokens"]) == 4
    assert body["usage"] == {
        "prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}
    # greedy determinism: same prompt -> same tokens
    code2, body2 = _post(endpoint.port, {"prompt": [5, 9, 2], "max_tokens": 4})
    assert body2["choices"][0]["tokens"] == choice["tokens"]


def test_concurrent_clients_batch(endpoint):
    results = {}

    def client(i, prompt):
        results[i] = _post(endpoint.port,
                           {"prompt": prompt, "max_tokens": 3})

    threads = [
        threading.Thread(target=client, args=(i, [3 + i, 1]))
        for i in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(code == 200 for code, _ in results.values()), results
    assert all(
        len(body["choices"][0]["tokens"]) == 3
        for _, body in results.values()
    )


def test_bad_requests(endpoint):
    code, body = _post(endpoint.port, {"prompt": "text needs a tokenizer"})
    assert code == 400 and "tokenizer" in body["error"]
    code, _ = _post(endpoint.port, {"prompt": [1.5]})
    assert code == 400
