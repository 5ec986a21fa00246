"""The parallel layer on a group of processes: training steps, the server,
the sharded top-k, ring and Ulysses attention and the training CLI, each
on a mesh of the group's first ranks, and what each computed written to
files. The tests launch it on gloo over CPU processes and hold the files
against the JAX package and the one-device port.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m zutis_tpu_torch.tools.parallel_check JOB.json

JOB.json: {"device": "cpu" or "cuda", "out": DIR, "cases": [CASE, ...]}.
Every rank runs every case in order; a case's "mesh" ({"data": D,
"model": M}) takes ranks 0 .. D*M-1, and the others wait for it. Inputs
come from an .npz ("inputs"); a model's parameters are its full state dict
under "param/<name>". The mesh's first rank writes <DIR>/<name>.npz (or
.json):

  train: {"model": ZUTIS kwargs, "n_categories", "steps", "base_lr",
          "n_iters"}; inputs: the parameters, the batch's four arrays of the
          global batch, "text". -> "loss", "ce_loss", "mask_loss" by step,
          "confusion", the parameters and AdamW's moments after the steps,
          gathered whole ("param/", "exp_avg/", "exp_avg_sq/"), and each
          rank's flash launches ("flash_launches").
  serve: {"model", "server": InferenceServer kwargs}; inputs: the
          parameters, "images", "text". The synchronous `infer` on the mesh
          and through start / submit / stop, against the one-device server
          on the same rank -> json.
  topk:  {"k"}; inputs: "text", "bank". -> `topk_sharded`'s "values",
          "indices" and `topk_local`'s on the whole bank.
  sp:    inputs: "q", "k", "v" [b, h, s, d]. -> "ring", "ulysses" and
          "dense" (ops/attention.py on the whole sequence), Ulysses' flash
          launches on each rank.
  cli:   {"args": [...]}: `zutis_tpu_torch.cli.main.main(args)` on the
          whole group (its config's mesh_axes make the mesh).

A case with a "seed" in place of "inputs" makes its inputs on each rank,
for a card run at full width: a ZUTIS of "model" in "dtype" from the seed
(train, serve), a global batch of "batch" ({"size", "image_size", "n_max",
"n_valid"}) or "requests" images, a unit-norm "bank" ([categories, rows,
dim]) or q, k, v of "shape" in "dtype", on the device. It writes
<name>.json: a train case's losses, its host ms a step over "time_steps"
more steps, with "profile" one more step's kernels (`profile_step`),
and, against an earlier case marked "keep" and named by "compare_to", the
largest loss and parameter differences; whether the
sharded top-k equals the local one, and its host ms (the first call); an
sp case's errors against dense attention. On "cuda" float32 products
stay in float32 (TF32 off).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from zutis_tpu_torch.engine.server import InferenceServer
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.ops.attention import dot_product_attention
from zutis_tpu_torch.ops.flash_attention import flash_attention
from zutis_tpu_torch.parallel import mesh as M
from zutis_tpu_torch.parallel import sp
from zutis_tpu_torch.retrieval.bank import topk_local, topk_sharded

PARAM = "param/"


def load_inputs(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def build_model(model_kwargs: dict, params: Dict[str, np.ndarray], device):
    """A ZUTIS of `model_kwargs` on `device` holding the full `params`."""
    from zutis_tpu_torch.models.zutis import ZUTIS

    model = ZUTIS(**model_kwargs, device=device)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                          strict=True)
    return model


def seeded_model(case: dict, device):
    """A ZUTIS of case["model"] in case["dtype"] with parameters from
    case["seed"] (the same on every rank)."""
    from zutis_tpu_torch.models.zutis import ZUTIS

    dtype = getattr(torch, case.get("dtype", "float32"))
    return ZUTIS(**case["model"], dtype=dtype, device=device).init_params(
        torch.Generator().manual_seed(case["seed"]))


def seeded_batch(case: dict):
    """(global batch, unit-norm text) from case["seed"]: case["batch"] =
    {"size", "image_size", "n_max", "n_valid"}, case["n_categories"]."""
    b = case["batch"]
    n, size, n_max = b["size"], b["image_size"], b["n_max"]
    rng = np.random.RandomState(case["seed"])
    text = rng.randn(case["n_categories"], case["model"]["text_dim"]).astype(
        np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    batch = {
        "image": rng.randn(n, 3, size, size).astype(np.float32),
        "instance_masks": (rng.rand(n, n_max, size, size) > 0.7).astype(
            np.float32),
        "instance_valid": np.repeat(np.arange(n_max)[None] < b["n_valid"],
                                    n, 0),
        "semantic_mask": rng.randint(0, case["n_categories"],
                                     (n, size, size)).astype(np.int32),
    }
    return batch, text


def train_steps(model, batch: Dict, text, n_categories: int, steps: int,
                mesh, base_lr: float = 1e-3, n_iters: int = 100,
                time_steps: int = 0, profile: bool = False) -> dict:
    """`steps` training steps of `model` (full parameters) on `mesh` over
    the global `batch`, each data rank stepping its slice. -> the global
    metrics by step, the last confusion, the state gathered whole, the
    flash launches of this rank, with `time_steps` the host ms a step of
    that many more, back to back with one read of the loss, and with
    `profile` one more step's kernels on a card (`profile_step`)."""
    M.shard_model(model, mesh)
    state = TrainState.create(model, base_lr=base_lr, n_iters=n_iters)
    step = make_train_step(model, text, n_categories, device=mesh.device)
    local = M.shard_batch(batch, mesh)
    flash_attention.launches = 0
    metrics: List[dict] = []
    for _ in range(steps):
        metrics.append(step(state, local))
    launches = flash_attention.launches
    step_ms = None
    if time_steps:
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(time_steps):
            m = step(state, local)
        m["loss"].item()
        step_ms = (time.perf_counter() - t0) * 1e3 / time_steps
    kernels = (profile_step(lambda: step(state, local)["loss"].item())
               if profile and mesh.device.type == "cuda" else None)
    ckpt = {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}
    if model.tp_specs:
        ckpt = M.gather_train_state(
            ckpt, model.tp_specs,
            M.optimizer_param_names(state.optimizer, model), mesh)
    names = M.optimizer_param_names(state.optimizer, model)
    out = {k: np.array([float(m[k]) for m in metrics])
           for k in ("loss", "ce_loss", "mask_loss")}
    out["confusion"] = metrics[-1]["confusion"].cpu().numpy()
    for k, v in ckpt["model"].items():
        out[PARAM + k] = v.detach().cpu().numpy()
    for i, s in ckpt["optimizer"]["state"].items():
        for moment in M.MOMENTS:
            out[f"{moment}/{names[int(i)]}"] = s[moment].cpu().numpy()
    out["flash_launches"] = launches
    if step_ms is not None:
        out["step_ms"] = step_ms
    if kernels is not None:
        out["profile"] = kernels
    return out


def profile_step(fn, top: int = 8) -> dict:
    """One call of `fn` under torch.profiler: its host ms, the device ms of
    its kernels (summed over streams), of NCCL's among them, their count,
    and the `top` kernels by device ms as [name, ms, count]."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"host_ms": wall,
            "device_ms": sum(ms for ms, _ in by_name.values()),
            "nccl_ms": sum(ms for k, (ms, _) in by_name.items()
                           if "nccl" in k.lower()),
            "kernels": sum(n for _, n in by_name.values()),
            "top": [[k[:80], ms, n] for k, (ms, n) in ranked]}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare_train(res: dict, ref: dict) -> dict:
    """A train case's losses, confusion and gathered parameters against a
    reference case's: the largest relative loss difference, whether the
    confusions are equal, the largest parameter error relative to
    max(|p|, 1)."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["loss"], ref["loss"]))
    err = max(float(np.max(np.abs(res[k].astype(np.float64) - v)
                           / np.maximum(np.abs(v), 1.0)))
              for k, v in ref.items() if k.startswith(PARAM))
    return {"loss_max_rel": float(rel), "param_max_rel": err,
            "confusion_equal": bool(np.array_equal(res["confusion"],
                                                   ref["confusion"]))}


def _same_results(a: List[dict], b: List[dict]) -> dict:
    """How far two servers' results differ: the semantic maps' agreement,
    the instances kept, their largest score difference."""
    sem = np.mean([np.mean(x["semantic"] == y["semantic"])
                   for x, y in zip(a, b)])
    same = all(
        [(i["category_id"], i["segmentation"]["counts"]) for i in x["instances"]]
        == [(i["category_id"], i["segmentation"]["counts"])
            for i in y["instances"]] for x, y in zip(a, b))
    diff = max([abs(i["score"] - j["score"]) for x, y in zip(a, b)
                for i, j in zip(x["instances"], y["instances"])] or [0.0])
    return {"semantic_agreement": float(sem), "same_instances": bool(same),
            "max_score_diff": float(diff),
            "instances": sum(len(x["instances"]) for x in a)}


def serve_compare(model, plain_model, text, images, server_kw: dict,
                  mesh) -> dict:
    """InferenceServer on `mesh` (sync `infer`, then start / submit / stop
    on the first rank with the others following) against the one-device
    server on `plain_model`, on this rank."""
    if mesh.model_size > 1:
        M.shard_model(model, mesh)
    served = InferenceServer(model, text, mesh=mesh, **server_kw)
    plain = InferenceServer(plain_model, text, device=mesh.device, **server_kw)
    want = plain.infer(images)
    got = served.infer(images)
    served.start()
    if mesh.is_writer:
        futures = [served.submit(im) for im in images]
        queued = [f.result(timeout=600) for f in futures]
    served.stop()
    out = {"sync": _same_results(got, want), "batches": served.batches}
    if mesh.is_writer:
        out["queued"] = _same_results(queued, want)
    return out


def ring_ulysses(q, k, v, mesh) -> dict:
    """Ring and Ulysses attention over the model axis, and dense attention
    on the whole sequence; Ulysses' flash launches on this rank."""
    ring = sp.make_ring_attention(mesh)(q, k, v)
    flash_attention.launches = 0
    ulysses = sp.make_ulysses_attention(mesh)(q, k, v)
    launches = flash_attention.launches
    with torch.no_grad():
        dense = dot_product_attention(q, k, v)
    return {"ring": ring, "ulysses": ulysses, "dense": dense,
            "ulysses_flash_launches": launches}


def _numpy(d: dict) -> dict:
    return {k: v.float().cpu().numpy() if torch.is_tensor(v) else v
            for k, v in d.items()}


def run_case(case: dict, job: dict, kept: dict) -> None:
    """Run `case` on its mesh; `kept` holds the train results of cases
    marked "keep" (on the mesh's first rank), for later cases'
    "compare_to"."""
    from zutis_tpu_torch.cli import main as cli_main

    if case["kind"] == "cli":
        cli_main.main(case["args"])
        return
    size = M.mesh_size(case["mesh"])
    mesh = M.create_mesh(case["mesh"], device=job["device"],
                         ranks=range(size))
    if mesh is not None:
        seeded = "seed" in case
        inputs = {} if seeded else load_inputs(case["inputs"])
        params = {k[len(PARAM):]: v for k, v in inputs.items()
                  if k.startswith(PARAM)}
        out_fp = Path(job["out"]) / case["name"]
        kind = case["kind"]
        if kind == "train":
            if seeded:
                model = seeded_model(case, mesh.device)
                batch, text = seeded_batch(case)
            else:
                model = build_model(case["model"], params, mesh.device)
                batch = {k: inputs[k] for k in ("image", "instance_masks",
                                               "instance_valid",
                                               "semantic_mask")}
                text = inputs["text"]
            res = train_steps(
                model, batch, text, case["n_categories"], case["steps"], mesh,
                base_lr=case.get("base_lr", 1e-3),
                n_iters=case.get("n_iters", 100),
                time_steps=case.get("time_steps", 0),
                profile=case.get("profile", False))
            del model
            launches = all_ranks_of(mesh, res.pop("flash_launches"))
            if mesh.is_writer and case.get("keep"):
                kept[case["name"]] = res
            if mesh.is_writer and seeded:
                summary = {"loss": res["loss"].tolist(),
                           "step_ms": res.get("step_ms"),
                           "profile": res.get("profile"),
                           "flash_launches": launches}
                if case.get("compare_to"):
                    summary.update(compare_train(res, kept[case["compare_to"]]))
                Path(f"{out_fp}.json").write_text(json.dumps(summary))
            elif mesh.is_writer:
                np.savez(f"{out_fp}.npz", flash_launches=launches, **res)
        elif kind == "serve":
            if seeded:  # case["requests"] images of the server's size
                models = [seeded_model(case, mesh.device) for _ in range(2)]
                rng = np.random.RandomState(case["seed"])
                text = rng.randn(case["n_categories"],
                                 case["model"]["text_dim"]).astype(np.float32)
                text /= np.linalg.norm(text, axis=1, keepdims=True)
                size = case["server"]["image_size"]
                images = [rng.randn(3, size, size).astype(np.float32)
                          for _ in range(case["requests"])]
            else:
                models = [build_model(case["model"], params, mesh.device)
                          for _ in range(2)]
                text, images = inputs["text"], list(inputs["images"])
            res = serve_compare(*models, text, images, case.get("server", {}),
                                mesh)
            if mesh.is_writer:
                Path(f"{out_fp}.json").write_text(json.dumps(res))
        elif kind == "topk":
            if seeded:  # case["bank"] = [categories, rows, dim], unit norm
                g = torch.Generator(device=mesh.device).manual_seed(
                    case["seed"])
                text, bank = (torch.randn(n, case["bank"][2], generator=g,
                                          device=mesh.device)
                              for n in case["bank"][:2])
                text /= torch.linalg.vector_norm(text, dim=1, keepdim=True)
                bank /= torch.linalg.vector_norm(bank, dim=1, keepdim=True)
            else:
                text, bank = (torch.from_numpy(inputs[n]).to(mesh.device)
                              for n in ("text", "bank"))
            _sync(mesh.device)
            t0 = time.perf_counter()
            vals, idx = topk_sharded(text, bank, case["k"], mesh)
            sharded_ms = (time.perf_counter() - t0) * 1e3
            lv, li = topk_local(text, bank, case["k"])
            if mesh.is_writer and seeded:
                Path(f"{out_fp}.json").write_text(json.dumps({
                    "indices_equal": bool(np.array_equal(idx, li.cpu().numpy())),
                    "values_equal": bool(np.array_equal(vals, lv.cpu().numpy())),
                    "sharded_ms": sharded_ms}))
            elif mesh.is_writer:
                np.savez(f"{out_fp}.npz", values=vals, indices=idx,
                         local_values=lv.cpu().numpy(),
                         local_indices=li.cpu().numpy())
        elif kind == "sp":
            if seeded:  # case["shape"] [b, h, s, d] in case["dtype"]
                g = torch.Generator(device=mesh.device).manual_seed(
                    case["seed"])
                q, k, v = (torch.randn(*case["shape"], generator=g,
                                       device=mesh.device).to(
                    getattr(torch, case.get("dtype", "float32")))
                    for _ in range(3))
            else:
                q, k, v = (torch.from_numpy(inputs[n]).to(mesh.device)
                           for n in "qkv")
            res = ring_ulysses(q, k, v, mesh)
            launches = all_ranks_of(mesh, res.pop("ulysses_flash_launches"))
            if mesh.is_writer and seeded:
                dense = res["dense"].float()
                top = float(dense.abs().max())
                Path(f"{out_fp}.json").write_text(json.dumps({
                    "ulysses_flash_launches": launches,
                    **{f"{n}_max_rel_err": float(
                        (res[n].float() - dense).abs().max()) / top
                       for n in ("ring", "ulysses")}}))
            elif mesh.is_writer:
                np.savez(f"{out_fp}.npz", ulysses_flash_launches=launches,
                         **_numpy(res))
        else:
            raise ValueError(f"case kind {kind!r}")
    dist.barrier()


def all_ranks_of(mesh, value) -> list:
    """`value` of every rank of `mesh`, in rank order."""
    out = [None] * mesh.size
    dist.all_gather_object(out, value, group=mesh.group)
    return out


def torchrun(nproc: int, args: List[str], timeout: float = 600,
             device: str = "cpu") -> subprocess.CompletedProcess:
    """`python -m torch.distributed.run --standalone` of `args` on `nproc`
    processes from the directory that holds this package (output
    captured)."""
    root = Path(__file__).resolve().parents[2]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *args]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""  # gloo over CPU tensors
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def run_job(job: dict, nproc: int, timeout: float = 600
            ) -> subprocess.CompletedProcess:
    """Write `job` to its "out" directory and run it on `nproc` processes."""
    fp = Path(job["out"]) / "job.json"
    fp.write_text(json.dumps(job))
    return torchrun(nproc, ["-m", "zutis_tpu_torch.tools.parallel_check",
                            str(fp)], timeout, job["device"])


# the cards' job: ViT-B/16 at bench.py:174-201's training configuration
# (384 px, batch 8, n_max 10 with 4 valid, 919 classes, AdamW + PolyLR over
# 80,000 iterations) and the serving shapes
CARD_BATCH = dict(size=8, image_size=384, n_max=10, n_valid=4)
CARD_CATEGORIES = 919
CARD_TIMED_STEPS = 5
CARD_SP_SHAPE = [8, 12, 2304, 64]  # the decoder memory's length, 2 or 4 ways
CARD_BANK = [80, 2_721_167, 768]  # COCO's categories over ImageNet + PASS
CARD_SERVER = dict(image_size=384, batch_size=8, threshold=0.5)


def card_job(n_cards: int, out: str, server_threshold: float = 0.5) -> dict:
    """Every mesh of `n_cards` cards (1, 2 or 4) against one card: two float32
    training steps each (lr 1e-5), compared with the one-card run's losses
    and parameters; a bf16 step, CARD_TIMED_STEPS timed ones and one
    profiled each;
    ring / Ulysses over the model axis; `topk_sharded` over the data axis;
    the server on each axis against the one-device server."""
    from zutis_tpu_torch.tools.instance_eval_bench import VIT_B16

    meshes = {f"dp{n_cards}": {"data": n_cards},
              f"tp{n_cards}": {"model": n_cards}}
    if n_cards == 4:
        meshes.update(dp2={"data": 2}, tp2={"model": 2},
                      dp2_tp2={"data": 2, "model": 2})
    train = dict(kind="train", model=VIT_B16, seed=0, batch=CARD_BATCH,
                 n_categories=CARD_CATEGORIES, base_lr=1e-5, n_iters=80_000)
    one = {"data": 1, "model": 1}
    cases = [dict(train, name="f32_one", mesh=one, steps=2, keep=True)]
    cases += [dict(train, name=f"f32_{k}", mesh=m, steps=2,
                   compare_to="f32_one") for k, m in meshes.items()]
    bf16 = dict(train, dtype="bfloat16", steps=1, time_steps=CARD_TIMED_STEPS,
                profile=True)
    cases.append(dict(bf16, name="bf16_one", mesh=one, keep=True))
    cases += [dict(bf16, name=f"bf16_{k}", mesh=m, compare_to="bf16_one")
              for k, m in meshes.items()]
    cases += [dict(kind="sp", name=f"sp_model{n_cards}", seed=26,
                   mesh={"model": n_cards}, shape=CARD_SP_SHAPE,
                   dtype="bfloat16"),
              dict(kind="topk", name=f"topk_data{n_cards}", seed=30,
                   mesh={"data": n_cards}, bank=CARD_BANK, k=500)]
    cases += [dict(kind="serve", name=f"serve_{axis}{n_cards}", seed=0,
                   mesh={axis: n_cards}, model=VIT_B16, dtype="bfloat16",
                   n_categories=CARD_CATEGORIES, requests=16,
                   server=dict(CARD_SERVER, threshold=server_threshold))
              for axis in ("data", "model")]
    return {"device": "cuda", "out": out, "cases": cases}


def main(argv=None) -> None:
    """JOB.json as the one argument (under torchrun), or `--cards N --out
    DIR [--threshold T]`: write `card_job(N)` to DIR and run it on N cards
    under torchrun."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[0] == "--cards":
        n, out = int(argv[1]), argv[3]
        Path(out).mkdir(parents=True, exist_ok=True)
        threshold = float(argv[5]) if len(argv) > 5 else 0.5
        t0 = time.perf_counter()
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout)
        proc = run_job(card_job(n, out, threshold), n, timeout=3000)
        print(proc.stdout[-20000:])
        print(proc.stderr[-20000:], file=sys.stderr)
        for fp in sorted(Path(out).glob("*.json")):
            if fp.name != "job.json":
                print(fp.stem, fp.read_text())
        print(f"{n} cards: {time.perf_counter() - t0:.1f} s")
        sys.exit(proc.returncode)
    job = json.loads(Path(argv[0]).read_text())
    device = torch.device(job["device"])
    if device.type == "cuda":  # no device_id: see parallel/mesh.py
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":  # float32 products in float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kept: dict = {}
    try:
        for case in job["cases"]:
            run_case(case, job, kept)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
