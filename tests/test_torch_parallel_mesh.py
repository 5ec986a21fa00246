"""The port's TP layout (zutis_tpu_torch/parallel/mesh.py) against the JAX
package's sharding rules, and its shard / gather inverses, on the CPU.

  * For every parameter of tiny ViT, RN and DINO ZUTIS models, at a model
    axis of 2 and 4: the values this rank's port shard holds are the values
    JAX's `params_sharding_tree` puts on the device of the same model
    coordinate, for the flax leaves the weights bridge
    (`models/weights.py::params_from_jax`) maps the parameter from. The
    named exceptions, where the port keeps a layer whole that GSPMD
    splits: the RN attention pool's q/k/v and c_proj weight (flax's
    attn/out_proj), and attentions whose heads the axis does not divide
    (the DINO arm at 3 heads of 16).
  * shard -> gather of parameters and AdamW's state (exp_avg, exp_avg_sq,
    step) gives them back bit for bit, at model axes 2 and 4.
  * the rules by name, as tests/test_retrieval_parallel.py checks JAX's;
    `shard_batch`; a mesh larger than the world refuses, naming the world
    size; a mesh of one needs no launcher.
"""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu.parallel.mesh import params_sharding_tree
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models.weights import (flatten_tree, params_from_jax,
                                            unflatten_tree)
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.parallel import mesh as M

COMMON = dict(n_queries=8, n_decoder_layers=1, n_heads=4)
CFGS = {
    "vit": dict(width=64, encoder_layers=1, encoder_heads=4, patch_size=16,
                text_dim=32, input_resolution=32, **COMMON),
    "rn": dict(encoder_family="rn", rn_layers=(1, 1, 1, 1), rn_width=8,
               width=256, text_dim=16, input_resolution=64, **COMMON),
    "dino": dict(encoder_family="dino", width=16, text_dim=16, patch_size=16,
                 input_resolution=32, dino_embed_dim=48, dino_depth=1,
                 dino_heads=3, **COMMON),
}
SIZES = {"vit": 32, "rn": 64, "dino": 32}


def _exception(family, name, model_size):
    """The port keeps these whole where GSPMD splits them."""
    if name.startswith("encoder.attnpool.") and "_proj." in name:
        # flax's attn/{q,k,v}_proj and attn/out_proj: JAX splits all but
        # out_proj's bias
        return name != "encoder.attnpool.c_proj.bias"
    # out_proj's bias is whole in both layouts
    return family == "dino" and name.startswith("encoder.blocks.") and (
        ".attn." in name) and not name.endswith("out_proj.bias") and (
        3 % model_size != 0)


def _leaves(tree):
    """{"a/b/c": leaf} of a pytree of any leaves."""
    return {"/".join(k.key for k in path): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=list(CFGS))
def family(request):
    """(name, the port's state dict with unique integer values, the flax
    leaves' value ranges, the flax tree)."""
    name = request.param
    size = SIZES[name]
    shapes = jax.eval_shape(JZUTIS(**CFGS[name]).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, size, size)))["params"]
    flat, ranges, offset = {}, {}, 0
    for path, leaf in _leaves(shapes).items():
        n = int(np.prod(leaf.shape))
        flat[path] = (offset + np.arange(n)).reshape(leaf.shape).astype(
            np.float32)
        ranges[path] = (offset, offset + n)
        offset += n
    assert offset < 2 ** 24  # exact in float32
    tree = unflatten_tree(flat)
    return name, params_from_jax(tree), ranges, tree


@pytest.mark.parametrize("model_size", [2, 4])
def test_port_shards_hold_the_values_jax_puts_on_each_device(family,
                                                             model_size):
    name, sd, ranges, tree = family
    devices = np.array(jax.devices()[:model_size]).reshape(1, model_size)
    jmesh = JMesh(devices, ("data", "model"))
    shardings = _leaves(params_sharding_tree(tree, jmesh))
    flat = flatten_tree(tree)
    starts = sorted((lo, path) for path, (lo, _) in ranges.items())
    los = np.array([lo for lo, _ in starts])

    def jax_values(path, r):
        sharding = shardings[path]
        idx = sharding.devices_indices_map(flat[path].shape)[devices[0, r]]
        return flat[path][idx].ravel()

    model = ZUTIS(**CFGS[name], device="cpu")
    specs = M.sharded_specs(model, model_size)
    params = dict(model.named_parameters())
    exceptions = set()
    for key, t in sd.items():
        values = t.numpy().ravel()
        sources = {starts[i][1] for i in np.unique(
            np.searchsorted(los, values, side="right") - 1)}
        for r in range(model_size):
            port = (M.shard_tensor(t, specs[key], model_size, r)
                    if key in specs else t).numpy().ravel()
            want = np.concatenate([jax_values(p, r) for p in sorted(sources)])
            if not np.array_equal(np.sort(port), np.sort(want)):
                exceptions.add(key)
        if key not in params:
            assert key not in specs  # buffers (BatchNorm statistics) stay whole
    named = {k for k in sd if k in params and _exception(name, k, model_size)}
    assert exceptions == named
    for key in named:  # GSPMD splits them, the port keeps them whole
        assert key not in specs


def _trained_state():
    model = ZUTIS(**CFGS["vit"], device="cpu").init_params(
        torch.Generator().manual_seed(0))
    state = TrainState.create(model, base_lr=1e-3, n_iters=10)
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(2, 3, 32, 32).astype(np.float32),
             "instance_masks": (rng.rand(2, 2, 32, 32) > 0.5).astype(
                 np.float32),
             "instance_valid": np.ones((2, 2), bool),
             "semantic_mask": rng.randint(0, 3, (2, 32, 32)).astype(np.int32)}
    text = rng.randn(3, 32).astype(np.float32)
    make_train_step(model, text, 3, device="cpu")(state, batch)
    return model, state


@pytest.mark.parametrize("model_size", [2, 4])
def test_shard_then_gather_gives_the_state_back_bit_for_bit(model_size):
    model, state = _trained_state()
    specs = M.sharded_specs(model, model_size)
    assert specs and all(k.endswith(("weight", "bias")) for k in specs)
    names = M.optimizer_param_names(state.optimizer, model)
    ckpt = {"model": model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": 1}
    shards = [M.shard_train_state(
        ckpt, specs, names, SimpleNamespace(model_size=model_size,
                                            model_rank=r))
        for r in range(model_size)]
    for k, v in ckpt["model"].items():
        parts = [s["model"][k] for s in shards]
        whole = M.merge_shards(parts, specs[k]) if k in specs else parts[0]
        assert torch.equal(whole, v), k
        if k in specs:
            assert parts[0].shape[specs[k].dim] * model_size == v.shape[
                specs[k].dim]
    for i, s in ckpt["optimizer"]["state"].items():
        spec = specs.get(names[i])
        for key, v in s.items():
            parts = [sh["optimizer"]["state"][i][key] for sh in shards]
            whole = (M.merge_shards(parts, spec)
                     if spec is not None and key in M.MOMENTS else parts[0])
            assert torch.equal(whole, v), (names[i], key)
    assert all(s["step"] == 1 for s in shards)


def test_the_in_proj_shard_is_each_heads_rows_of_q_k_and_v():
    t = torch.arange(3 * 8).reshape(3 * 8, 1)  # q 0-7, k 8-15, v 16-23
    spec = M.param_partition_spec("decoder.layers.0.self_attn.in_proj_weight")
    assert spec == M.Spec(0, 3)
    assert M.shard_tensor(t, spec, 2, 1).flatten().tolist() == [
        4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]


def test_partition_rules():
    spec = M.param_partition_spec
    assert spec("encoder.transformer.resblocks.0.attn.in_proj_weight") == (0, 3)
    assert spec("encoder.transformer.resblocks.0.attn.out_proj.weight") == (1, 1)
    assert spec("encoder.transformer.resblocks.0.attn.out_proj.bias") is None
    assert spec("decoder.layers.1.linear1.weight") == (0, 1)
    assert spec("decoder.layers.1.linear2.weight") == (1, 1)
    assert spec("encoder.positional_embedding") is None
    assert spec("ffn1.layers.0.weight") == (0, 1)
    assert spec("ffn1.layers.1.weight") == (1, 1)
    assert spec("ffn1.layers.2.weight") is None
    assert spec("vision_to_text_ffn.layers.0.weight") is None
    assert spec("encoder.attnpool.q_proj.weight") is None


def test_shard_batch_takes_the_data_ranks_rows():
    batch = {"image": np.arange(8).reshape(4, 2), "valid": np.arange(4)}
    for r in range(2):
        mesh = SimpleNamespace(shape={"data": 2, "model": 1},
                               axis_rank=lambda axis, r=r: r)
        got = M.shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["valid"], [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(got["image"], batch["image"][2 * r:2 * r + 2])


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 2, "model": 2}])
def test_a_mesh_larger_than_the_world_refuses(axes):
    n = int(np.prod(list(axes.values())))
    with pytest.raises(ValueError, match=f"a mesh of {n} ranks, but the "
                       "world size is 1"):
        M.create_mesh(axes, device="cpu")
    with pytest.raises(ValueError, match="mesh axes"):
        M.create_mesh({"pipe": 1}, device="cpu")


def test_a_mesh_of_one_needs_no_launcher():
    code = ("from zutis_tpu_torch.parallel import create_mesh, close_mesh\n"
            "m = create_mesh({'data': 1, 'model': 1}, device='cpu')\n"
            "print(m.shape, m.data_rank, m.model_rank, m.is_writer, m.device)\n"
            "close_mesh(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == (
        "{'data': 1, 'model': 1} 0 0 True cpu")
