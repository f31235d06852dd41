"""Pod-mesh construction on the virtual 8-device backend (single process)."""

import jax
import jax.numpy as jnp
import numpy as np

from xbitops.models import llama
from xbitops.parallel import model_tp
from xbitops.parallel.multihost import make_pod_mesh


def test_make_pod_mesh_shapes():
    mesh = make_pod_mesh(tp=4)
    assert dict(mesh.shape) == {"data": 2, "model": 4}
    mesh = make_pod_mesh(tp=8)
    assert dict(mesh.shape) == {"data": 1, "model": 8}
    # each model-axis row holds consecutive devices of one process
    rows = np.asarray(make_pod_mesh(tp=4).devices)
    assert [[d.id for d in r] for r in rows] == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_pod_mesh_runs_dp_tp_decode():
    mesh = make_pod_mesh(tp=4)
    cfg = llama.LlamaConfig(
        vocab_size=1024, hidden_size=256, intermediate_size=512,
        num_layers=1, num_heads=4, num_kv_heads=4, head_dim=128, max_seq_len=16,
    )
    params = llama.init_params(jax.random.PRNGKey(0), cfg, bits=8, group_size=32, tp=4)
    params = model_tp.shard_params(params, mesh)
    cache = llama.KVCache.init(cfg, 4)
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        cache, model_tp.cache_pspecs("model", "data"),
    )
    logits, cache = model_tp.tp_decode_step(
        params, cfg, mesh, jnp.zeros(4, jnp.int32), cache, data_axis="data"
    )
    assert logits.shape == (4, cfg.vocab_size)
    assert bool(np.isfinite(np.asarray(logits, np.float32)).all())
