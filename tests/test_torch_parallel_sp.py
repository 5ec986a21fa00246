"""The port's sequence-parallel attention, sharded top-k and server on a
mesh (zutis_tpu_torch/parallel/sp.py, retrieval/bank.py::topk_sharded,
engine/server.py with `mesh=`) on two gloo ranks over CPU processes,
against the JAX package on a 2-device CPU mesh:

  * ring and Ulysses attention over the model axis against JAX's
    `make_ring_attention` / `make_ulysses_attention` and dense attention,
    rtol / atol 2e-5 (tests/test_sequence_parallel.py), a long sequence
    too;
  * `topk_sharded` over the data axis at N = 203 (not a multiple of the
    shards), k = 7: values against JAX's `topk_sharded` at rtol 1e-5,
    indices equal to `topk_local`'s; and on a bank with duplicate rows, in
    `jax.lax.top_k`'s tie order;
  * `InferenceServer(mesh=)` at DP=2 and TP=2 (tests/test_torch_server.py's
    tiny config, 7 requests in batches of 4): `infer` on every rank and
    start / submit / stop on the first with the other following, against
    the one-device server: semantic maps, instances and RLE strings equal,
    scores within 1e-5.

One torchrun of 2 processes (`tools/parallel_check.py`) runs every case;
the ranks import torch only."""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu.ops.attention import dot_product_attention
from zutis_tpu.parallel import create_mesh as jcreate_mesh
from zutis_tpu.parallel.sp import make_ring_attention, make_ulysses_attention
from zutis_tpu.retrieval.bank import topk_local as jtopk_local
from zutis_tpu.retrieval.bank import topk_sharded as jtopk_sharded
from zutis_tpu_torch.models.weights import params_from_jax
from zutis_tpu_torch.tools import parallel_check

SP_SHAPES = {"sp": (2, 8, 64, 16, 0), "sp_long": (1, 4, 512, 32, 2)}
SERVE_CFG = dict(width=32, encoder_layers=1, encoder_heads=2, patch_size=16,
                 text_dim=16, n_queries=6, n_decoder_layers=1, n_heads=2,
                 input_resolution=32)
SERVER = dict(image_size=32, batch_size=4, threshold=0.4)
SERVE_MESHES = {"serve_dp2": {"data": 2, "model": 1},
                "serve_tp2": {"data": 1, "model": 2}}


def _qkv(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))


def _banks():
    rng = np.random.RandomState(0)
    text = rng.randn(5, 16).astype(np.float32)
    bank = rng.randn(203, 16).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    dup = bank.copy()
    dup[100:140] = dup[:40]  # rows both archives hold: exact ties
    dup[180:] = dup[40]
    return {"topk": (text, bank), "topk_ties": (text, dup)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_sp")
    cases = []
    for name, (b, h, s, d, seed) in SP_SHAPES.items():
        q, k, v = _qkv(b, h, s, d, seed)
        np.savez(out / f"{name}_in.npz", q=q, k=k, v=v)
        cases.append(dict(kind="sp", name=name, mesh={"model": 2},
                          inputs=str(out / f"{name}_in.npz")))
    for name, (text, bank) in _banks().items():
        np.savez(out / f"{name}_in.npz", text=text, bank=bank)
        cases.append(dict(kind="topk", name=name, mesh={"data": 2}, k=7,
                          inputs=str(out / f"{name}_in.npz")))
    params = JZUTIS(**SERVE_CFG).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 3, 32, 32)))["params"]
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(0)
    text = rng.randn(4, 16).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    images = np.stack([rng.randn(3, 32, 32).astype(np.float32)
                       for _ in range(7)])
    np.savez(out / "serve_in.npz", text=text, images=images,
             **{f"param/{k}": v.numpy() for k, v in sd.items()})
    for name, mesh in SERVE_MESHES.items():
        cases.append(dict(kind="serve", name=name, mesh=mesh, model=SERVE_CFG,
                          server=SERVER, inputs=str(out / "serve_in.npz")))
    proc = parallel_check.run_job(
        {"device": "cpu", "out": str(out), "cases": cases}, nproc=2)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:2]), ("model",))


@pytest.mark.parametrize("name", list(SP_SHAPES))
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_sequence_parallel_matches_jax_and_dense(runs, jmesh, name, scheme):
    b, h, s, d, seed = SP_SHAPES[name]
    q, k, v = (jnp.asarray(x) for x in _qkv(b, h, s, d, seed))
    make = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}
    want = np.asarray(make[scheme](jmesh, "model")(q, k, v))
    dense = np.asarray(dot_product_attention(q, k, v, impl="xla"))
    with np.load(runs / f"{name}.npz") as f:
        got, port_dense = f[scheme], f["dense"]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port_dense, dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["topk", "topk_ties"])
def test_topk_sharded_matches_jax_and_the_local_top_k(runs, name):
    text, bank = _banks()[name]
    jvals, _ = jtopk_sharded(text, bank, 7, jcreate_mesh(
        {"data": 2}, devices=jax.devices()[:2]))
    _, jidx = jtopk_local(jnp.asarray(text), jnp.asarray(bank), 7)
    with np.load(runs / f"{name}.npz") as f:
        np.testing.assert_allclose(f["values"], jvals, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(f["indices"], f["local_indices"])
        np.testing.assert_array_equal(f["values"], f["local_values"])
        # jax.lax.top_k's order among the duplicates
        np.testing.assert_array_equal(f["indices"], np.asarray(jidx))


@pytest.mark.parametrize("name", list(SERVE_MESHES))
@pytest.mark.parametrize("api", ["sync", "queued"])
def test_server_on_a_mesh_returns_the_one_device_results(runs, name, api):
    res = json.loads((runs / f"{name}.json").read_text())[api]
    assert res["semantic_agreement"] == 1.0
    assert res["same_instances"] and res["instances"] > 0
    assert res["max_score_diff"] <= 1e-5
