"""The port's DP x TP training (zutis_tpu_torch/parallel/, engine/train_step.py
on a mesh) on gloo over CPU processes, against the JAX package's
single-device step and the port's one-rank step, at
tests/test_multichip_equivalence.py's tiny ZUTIS (width 64, 2 encoder
layers of 4 heads, 32 px, batch 4, n_max 3, 4 classes): two steps at DP=2,
TP=2 and a 4-rank 2 x 2, and with ToMe (r = 1 a block) at TP=2.

One torchrun of 4 processes (`tools/parallel_check.py`) runs every case;
the ranks import torch only, and the JAX side runs in this process.

  * against JAX: the losses at the port's parity tolerance (rtol 1e-4, as
    tests/test_torch_train_step.py), the confusion equal;
  * against the one-rank port: the losses at rtol 1e-5, the confusion
    equal, every parameter's largest error relative to max(|p|, 1) below
    1e-4 (test_multichip_equivalence.py's tolerances; Adam turns the
    reduction order's noise in near-zero gradients into moves of O(lr)),
    and, after one step at TP=2 and 2 x 2, AdamW's moments gathered whole
    within 1e-4 of each tensor's largest |value| (of 1e-6 of the largest
    moment for tensors whose gradients are rounding noise).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zutis_tpu.engine.optim import make_optimizer as jmake_optimizer
from zutis_tpu.engine.train_step import TrainState as JTrainState
from zutis_tpu.engine.train_step import make_train_step as jmake_train_step
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models.weights import params_from_jax
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.tools import parallel_check

CFG = dict(width=64, encoder_layers=2, encoder_heads=4, patch_size=16,
           text_dim=32, n_queries=16, n_decoder_layers=2, n_heads=4,
           input_resolution=32)
N_CAT, STEPS, LR, N_ITERS = 4, 2, 1e-5, 100
CASES = {  # name -> (mesh, ToMe's r)
    "dp2": ({"data": 2, "model": 1}, 0),
    "tp2": ({"data": 1, "model": 2}, 0),
    "dp2_tp2": ({"data": 2, "model": 2}, 0),
    "tome_tp2": ({"data": 1, "model": 2}, 1),
}
# one step each, for AdamW's moments: a second step's matching may differ
# on near-tied costs, which moves a few queries' gradients
MOMENT_CASES = {"tp2_one_step": {"data": 1, "model": 2},
                "dp2_tp2_one_step": {"data": 2, "model": 2}}


def _batch():
    rng = np.random.RandomState(0)
    b, H, n_max = 4, 32, 3
    batch = {
        "image": rng.randn(b, 3, H, H).astype(np.float32),
        "instance_masks": (rng.rand(b, n_max, H, H) > 0.7).astype(np.float32),
        "instance_valid": np.ones((b, n_max), bool),
        "semantic_mask": rng.randint(0, N_CAT, (b, H, H)).astype(np.int32),
    }
    text = rng.randn(N_CAT, 32).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return batch, text


def _jax_steps(params, batch, text, tome_r):
    jmodel = JZUTIS(**CFG, tome_r=tome_r)
    tx = jmake_optimizer(base_lr=LR, n_iters=N_ITERS)
    step = jmake_train_step(jmodel, tx, jnp.asarray(text), n_categories=N_CAT)
    state = JTrainState.create(jax.tree.map(jnp.array, params), tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, jbatch)
        losses.append(float(metrics["loss"]))
    return np.array(losses), np.asarray(metrics["confusion"])


def _port_steps(sd, batch, text, tome_r, steps=STEPS):
    model = ZUTIS(**CFG, tome_r=tome_r, device="cpu")
    model.load_state_dict(sd, strict=True)
    state = TrainState.create(model, base_lr=LR, n_iters=N_ITERS)
    step = make_train_step(model, text, N_CAT, device="cpu")
    metrics = [step(state, batch) for _ in range(steps)]
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {f"{m}/{names[id(p)]}": s[m].numpy()
               for p, s in state.optimizer.state.items()
               for m in ("exp_avg", "exp_avg_sq")}
    return dict(loss=np.array([float(m["loss"]) for m in metrics]),
                confusion=metrics[-1]["confusion"].numpy(),
                params={k: v.numpy() for k, v in model.state_dict().items()},
                moments=moments)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_train")
    batch, text = _batch()
    params = jax.jit(JZUTIS(**CFG).init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"]))["params"]
    params = jax.tree.map(np.asarray, params)
    sd = params_from_jax(params)
    np.savez(out / "inputs.npz", text=text, **batch,
             **{f"param/{k}": v.numpy() for k, v in sd.items()})
    job = {"device": "cpu", "out": str(out), "cases": [
        dict(kind="train", name=name, mesh=mesh,
             model=dict(CFG, tome_r=tome_r), inputs=str(out / "inputs.npz"),
             n_categories=N_CAT, steps=STEPS, base_lr=LR, n_iters=N_ITERS)
        for name, (mesh, tome_r) in CASES.items()] + [
        dict(kind="train", name=name, mesh=mesh, model=CFG,
             inputs=str(out / "inputs.npz"), n_categories=N_CAT, steps=1,
             base_lr=LR, n_iters=N_ITERS)
        for name, mesh in MOMENT_CASES.items()]}
    proc = parallel_check.run_job(job, nproc=4)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mesh_runs = {}
    for name in [*CASES, *MOMENT_CASES]:
        with np.load(out / f"{name}.npz") as f:
            mesh_runs[name] = {k: f[k] for k in f.files}
    refs = {}
    for tome_r in sorted({r for _, r in CASES.values()}):
        refs[tome_r] = dict(jax=_jax_steps(params, batch, text, tome_r),
                            port=_port_steps(sd, batch, text, tome_r))
    refs["one_step"] = _port_steps(sd, batch, text, 0, steps=1)
    return mesh_runs, refs


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_the_jax_step(runs, name):
    got = runs[0][name]
    jloss, jconfusion = runs[1][CASES[name][1]]["jax"]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-4)
    np.testing.assert_array_equal(got["confusion"], jconfusion)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_the_one_rank_step(runs, name):
    got, want = runs[0][name], runs[1][CASES[name][1]]["port"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert {k[len("param/"):] for k in got if k.startswith("param/")} == set(
        want["params"])
    for k, w in want["params"].items():
        g = got[f"param/{k}"]
        assert g.shape == w.shape, k
        rel = np.abs(g.astype(np.float64) - w) / np.maximum(np.abs(w), 1.0)
        assert rel.max() < 1e-4, (k, rel.max())


@pytest.mark.parametrize("name", list(MOMENT_CASES))
def test_gathered_moments_match_the_one_rank_state(runs, name):
    got, want = runs[0][name], runs[1]["one_step"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(want["moments"]) <= set(got)
    # decoder layer 0's self-attention sees tgt = 0: its gradients, and so
    # its moments, are rounding noise; held to the moments' own scale
    top = {m: max(float(np.abs(w).max()) for k, w in want["moments"].items()
                  if k.startswith(m + "/")) for m in ("exp_avg", "exp_avg_sq")}
    for k, w in want["moments"].items():
        scale = max(float(np.abs(w).max()), 1e-6 * top[k.split("/")[0]])
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, k


def test_the_launch_counts_are_each_ranks_own(runs):
    # on the CPU the plain version runs and counts nothing; on a card each
    # rank counts its own launches, as many as one rank's
    for name, (mesh, _) in CASES.items():
        launches = runs[0][name]["flash_launches"]
        assert len(launches) == mesh["data"] * mesh["model"]
        assert len(set(launches.tolist())) == 1
