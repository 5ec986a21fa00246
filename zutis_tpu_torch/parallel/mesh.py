"""Device mesh and sharding, DP x TP (the port of zutis_tpu/parallel/mesh.py).

The JAX package drives every device from one process and lets GSPMD insert
the collectives. The port runs one process a device, started by torchrun
(`python -m torch.distributed.run --nproc_per_node N ...`), and inserts them
itself:

  data  - each data rank steps its contiguous slice of the global batch
          (`shard_batch`); the criterion divides by the global counts and
          the gradients are summed over the data group (parallel/dp.py), so
          the sum is the one-device gradient;
  model - Megatron tensor parallelism (parallel/tp.py): the attentions'
          heads and the MLPs' hidden features split over the model group,
          in the column / row pairs of the JAX package's rules.

`param_partition_spec` gives those rules over the port's parameter names.
A layer shards as a whole or not at all: an attention by whole heads, when
the model axis divides its heads; an MLP pair when the axis divides its
hidden width. Otherwise it stays whole on every rank, as a dimension the
axis does not divide stays whole in JAX (`params_sharding_tree`); the math
is the same, only the layout differs from GSPMD's. The RN attention pool
(`models/resnet.py::AttentionPool2d`, one call an image) stays whole, where
JAX splits its q/k/v and its c_proj's weight (flax's attn/out_proj).

Checkpoints hold full tensors: `gather_params` / `gather_train_state`
assemble them on save, `shard_params` / `shard_train_state` slice them on
restore, AdamW's `exp_avg` / `exp_avg_sq` like their parameters, so a
resume may change the factorisation.
"""
from __future__ import annotations

import math
import os
import re
from datetime import timedelta
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")


class Spec(NamedTuple):
    """A sharded parameter: its `dim` is `blocks` equal blocks (3 for the
    fused q, k, v projection), each split evenly over the model axis."""
    dim: int
    blocks: int = 1


# the JAX rules (zutis_tpu/parallel/mesh.py:46-59) over the port's names;
# torch's Linear weight is [out, in], so a kernel's P(None, m) is dim 0
_TP_RULES = [
    # attention: q/k/v by output features (whole heads), out_proj by input
    (r".*\.in_proj_(weight|bias)$", Spec(0, 3)),
    (r".*\.out_proj\.weight$", Spec(1)),
    # transformer MLPs: the expansion by output, the contraction by input
    (r".*\.mlp\.c_fc\.(weight|bias)$", Spec(0)),
    (r".*\.mlp\.c_proj\.weight$", Spec(1)),
    (r".*\.linear1\.(weight|bias)$", Spec(0)),
    (r".*\.linear2\.weight$", Spec(1)),
    # ffn1 / ffn2: the 256-wide hidden layers
    (r"(.*\.)?ffn[12]\.layers\.0\.(weight|bias)$", Spec(0)),
    (r"(.*\.)?ffn[12]\.layers\.1\.weight$", Spec(1)),
]


def param_partition_spec(name: str) -> Optional[Spec]:
    """The TP rule for the port's parameter `name`; None: replicated."""
    for pattern, spec in _TP_RULES:
        if re.match(pattern, name):
            return spec
    return None


def mesh_shape(axis_sizes: Mapping[str, int]) -> Dict[str, int]:
    """{"data": D, "model": M} from a config's `mesh_axes` (a missing axis
    is 1)."""
    unknown = set(axis_sizes) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: the port's mesh has "
                         f"the axes {AXES}")
    shape = {a: int(axis_sizes.get(a, 1)) for a in AXES}
    if min(shape.values()) < 1:
        raise ValueError(f"mesh {dict(axis_sizes)}: every axis needs >= 1")
    return shape


def mesh_size(axis_sizes: Optional[Mapping[str, int]]) -> int:
    return math.prod(mesh_shape(axis_sizes or {}).values())


# how long `Mesh.barrier` waits: long enough for the first rank to
# pseudo-label a retrieved set (hours) while the others wait on the host
HOST_TIMEOUT = timedelta(hours=12)


class Mesh:
    """This rank's place in a data x model mesh of processes: `shape`, the
    rank's `data_rank` / `model_rank`, the `data_group` / `model_group` it
    belongs to, `group` (every rank of the mesh, the device's backend),
    `host_group` (the same ranks on gloo, for waits on the host) and its
    `device`."""

    def __init__(self, device_mesh, device: torch.device, ranks: List[int],
                 group, host_group, owns_process_group: bool):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = dict(zip(AXES, device_mesh.mesh.shape))
        self.ranks = ranks
        self.rank = dist.get_rank()
        self.data_rank, self.model_rank = device_mesh.get_coordinate()
        self.data_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")
        self.group, self.host_group = group, host_group
        self.owns_process_group = owns_process_group

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def is_writer(self) -> bool:
        """The rank that writes logs, artifacts and checkpoints."""
        return self.rank == self.ranks[0]

    def axis_group(self, axis: str):
        return {"data": self.data_group, "model": self.model_group}[axis]

    def axis_rank(self, axis: str) -> int:
        return {"data": self.data_rank, "model": self.model_rank}[axis]

    def barrier(self) -> None:
        """Wait on the host for every rank of the mesh (up to HOST_TIMEOUT)."""
        dist.barrier(group=self.host_group)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}: data {self.data_rank}, "
                f"model {self.model_rank}, {self.device})")


def _init_process_group(n: int, device: torch.device) -> bool:
    """Start this process's group if it has none: from torchrun's
    environment, or a one-rank group for a mesh of one. -> whether it was
    started here."""
    if dist.is_initialized():
        return False
    # no `device_id`: it makes NCCL create its communicators eagerly, and
    # a four-card job of meshes over subsets of the ranks hung with it
    # where the same job without it ran
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timedelta(minutes=10))
        return True
    if n != 1:
        raise ValueError(
            f"a mesh of {n} ranks, but the world size is 1: launch one "
            f"process a device, e.g. python -m torch.distributed.run "
            f"--nproc_per_node {n} ...")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return True


def create_mesh(axis_sizes: Mapping[str, int], device="cuda",
                ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A data x model `Mesh` over `ranks` (default: every process of the
    group that torchrun started; a mesh of one needs no launcher). The
    product of the axes must equal their count, as JAX's
    `create_mesh` asserts. device="cuda" places the rank on
    `cuda:{LOCAL_RANK}` over NCCL, "cpu" on gloo. Every process of the
    group calls it; a rank outside `ranks` gets None."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape = mesh_shape(axis_sizes)
    n = math.prod(shape.values())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on device 'cuda' but "
                               "torch.cuda.is_available() is False; pass "
                               "device='cpu' to run on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    owns = _init_process_group(n, device)
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != n:
        raise ValueError(
            f"mesh_axes {dict(axis_sizes)} spans {n} ranks, but the world "
            f"size is {world}" + ("" if len(ranks) == world else
                                  f" and {len(ranks)} ranks were given"))
    dims = (shape["data"], shape["model"])
    if ranks == list(range(world)):
        dm = init_device_mesh(device.type, dims, mesh_dim_names=AXES)
    else:
        dm = DeviceMesh(device.type, torch.tensor(ranks).reshape(dims),
                        mesh_dim_names=AXES)
    group = dist.new_group(ranks) if world > 1 else dist.group.WORLD
    host_group = dist.new_group(ranks, backend="gloo", timeout=HOST_TIMEOUT)
    if dist.get_rank() not in ranks:
        return None
    return Mesh(dm, device, ranks, group, host_group, owns)


def close_mesh(mesh: Optional[Mesh]) -> None:
    """End the process group if `create_mesh` started it."""
    if mesh is not None and mesh.owns_process_group and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- tensors

def shard_tensor(t: torch.Tensor, spec: Spec, n: int, r: int) -> torch.Tensor:
    """Shard `r` of `n` of a full tensor (a copy): each of its
    `spec.blocks` blocks along `spec.dim` split evenly, rank r's pieces
    side by side."""
    block = t.shape[spec.dim] // spec.blocks
    step = block // n
    pieces = [t.narrow(spec.dim, j * block + r * step, step)
              for j in range(spec.blocks)]
    return torch.cat(pieces, spec.dim) if len(pieces) > 1 else pieces[0].clone()


def merge_shards(shards: Sequence[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The full tensor from every rank's shard, in model-rank order (the
    inverse of `shard_tensor`)."""
    per_rank = [s.chunk(spec.blocks, spec.dim) for s in shards]
    return torch.cat([per_rank[r][j] for j in range(spec.blocks)
                      for r in range(len(shards))], spec.dim)


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from this rank's shard (a collective over the model
    group)."""
    t = t.contiguous()
    shards = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(shards, t, group=mesh.model_group)
    return merge_shards(shards, spec)


# ------------------------------------------------------------------ model

def sharded_specs(model: torch.nn.Module, model_size: int) -> Dict[str, Spec]:
    """{parameter name: Spec} of the parameters of `model` that shard over
    a model axis of `model_size`: those of a rule whose layer shards as a
    whole (see the module's docstring)."""
    from zutis_tpu_torch.models.layers import MultiHeadAttention

    if model_size == 1:
        return {}
    whole = tuple(f"{name}." for name, m in model.named_modules()
                  if isinstance(m, MultiHeadAttention) and m.heads % model_size)
    specs = {}
    for name, p in model.named_parameters():
        spec = param_partition_spec(name)
        if (spec is None or name.startswith(whole)
                or p.shape[spec.dim] // spec.blocks % model_size):
            continue
        specs[name] = spec
    return specs


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Place `model` (full parameters, the same on every rank, on
    `mesh.device`) on the mesh in place: its TP parameters keep this rank's
    slices, its attentions and MLP pairs run tensor-parallel over the model
    group, and `model.mesh` / `model.tp_specs` record the layout for the
    train step, the Trainer and checkpoints. Call it before the optimiser
    is made."""
    from zutis_tpu_torch.models.layers import Dense, MultiHeadAttention

    specs = sharded_specs(model, mesh.model_size)
    n, r = mesh.model_size, mesh.model_rank
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in specs:
                p.data = shard_tensor(p.data, specs[name], n, r)
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, MultiHeadAttention) and f"{prefix}in_proj_weight" in specs:
            m.set_model_parallel(mesh.model_group, n)
        elif isinstance(m, Dense) and f"{prefix}weight" in specs:
            m.set_model_parallel(
                mesh.model_group,
                "column" if specs[f"{prefix}weight"].dim == 0 else "row")
    model.mesh = mesh
    model.tp_specs = specs
    return model


def mesh_of(model: torch.nn.Module) -> Optional[Mesh]:
    """The mesh `shard_model` placed `model` on, or None."""
    return getattr(model, "mesh", None)


def shard_params(params: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full state dict."""
    return {k: shard_tensor(v, specs[k], mesh.model_size, mesh.model_rank)
            if k in specs else v for k, v in params.items()}


def gather_params(params: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's slices (a collective over the
    model group; every rank gets it)."""
    return {k: gather_tensor(v, specs[k], mesh) if k in specs else v
            for k, v in params.items()}


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with full tensors: gathered on every rank of
    the mesh for a sharded model."""
    sd = model.state_dict()
    mesh = mesh_of(model)
    if mesh is None or not model.tp_specs:
        return sd
    return gather_params(sd, model.tp_specs, mesh)


def optimizer_param_names(optimizer: torch.optim.Optimizer,
                          model: torch.nn.Module) -> List[str]:
    """The parameter name of each index of `optimizer.state_dict()`."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


MOMENTS = ("exp_avg", "exp_avg_sq")


def _map_moments(opt_sd: dict, names: Sequence[str], specs, fn) -> dict:
    state = {}
    for i, s in opt_sd["state"].items():
        spec = specs.get(names[int(i)])
        state[i] = {k: fn(v, spec) if spec is not None and k in MOMENTS else v
                    for k, v in s.items()}
    return {"state": state, "param_groups": opt_sd["param_groups"]}


def shard_train_state(ckpt: Mapping, specs: Mapping[str, Spec],
                      names: Sequence[str], mesh: Mesh) -> dict:
    """This rank's slices of a full checkpoint {"model", "optimizer", ...}:
    parameters by the TP rules, AdamW's moments like their parameters;
    the rest (the scheduler, the step, AdamW's step counts) whole."""
    n, r = mesh.model_size, mesh.model_rank
    out = dict(ckpt)
    out["model"] = shard_params(ckpt["model"], specs, mesh)
    out["optimizer"] = _map_moments(
        ckpt["optimizer"], names, specs,
        lambda v, spec: shard_tensor(v, spec, n, r))
    return out


def gather_train_state(ckpt: Mapping, specs: Mapping[str, Spec],
                       names: Sequence[str], mesh: Mesh) -> dict:
    """The inverse of `shard_train_state` (collectives over the model
    group)."""
    out = dict(ckpt)
    out["model"] = gather_params(ckpt["model"], specs, mesh)
    out["optimizer"] = _map_moments(
        ckpt["optimizer"], names, specs,
        lambda v, spec: gather_tensor(v, spec, mesh))
    return out


# ------------------------------------------------------------------ batch

def shard_batch(batch: Mapping, mesh: Mesh, axis: str = "data") -> dict:
    """Every leaf's contiguous slice of its leading (batch) dimension for
    this rank's coordinate on `axis`, which must divide it."""
    n, r = mesh.shape[axis], mesh.axis_rank(axis)

    def place(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} over a {axis} axis of {n}")
        return x[r * (b // n):(r + 1) * (b // n)]

    return {k: place(v) for k, v in batch.items()}


def replicate(tree, mesh: Mesh):
    """A tensor, or a dict of them, on this rank's device: in the
    one-process-a-device idiom each rank holds its own copy."""
    if isinstance(tree, Mapping):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return torch.as_tensor(tree).to(mesh.device)
