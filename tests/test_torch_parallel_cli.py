"""The port's training CLI on a mesh (the port of tests/test_cli_mesh.py):
`mesh_axes` in the YAML, launched by torchrun on gloo over CPU processes
with `--device cpu`.

  * 4 steps at DP=2 (`{data: 2, model: 1}`), full checkpoints every 2 steps
    and evaluations at 2 and 4 on every rank; the mesh's first rank alone
    writes the artifacts (one line a log point) and the figures, which
    every rank's forward feeds;
  * preemption: step 4's checkpoint and the final model are lost, and the
    run resumes at TP=2 (`{data: 1, model: 2}`): the checkpoint holds whole
    tensors, which the other factorisation slices;
  * both final models against the one-rank CLI run's (no mesh_axes, this
    process), each parameter's largest error relative to max(|p|, 1)
    below 5e-4 (tests/test_cli_mesh.py's tolerance).
"""
import os
import shutil

import numpy as np
import pytest

from fixture_helpers import base_cli_cfg, dump_cfg, write_cli_fixture
from zutis_tpu_torch.cli import main as port_main
from zutis_tpu_torch.tools import parallel_check


def _run_dir(base):
    found = [dp for dp, _, fns in os.walk(base) if "config.json" in fns]
    assert len(found) == 1, found
    return found[0]


def _max_rel_err(npz_a, npz_b):
    with np.load(npz_a) as a, np.load(npz_b) as b:
        assert set(a.files) == set(b.files)
        return max(float(np.max(np.abs(a[k].astype(np.float64) - b[k])
                                / np.maximum(np.abs(b[k]), 1.0)))
                   for k in a.files)


def _torchrun_cli(cfg_fp):
    proc = parallel_check.torchrun(
        2, ["-m", "zutis_tpu_torch.cli.main", "--p_config", str(cfg_fp),
            "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    parts = write_cli_fixture(root, n_val_images=1)
    common = dict(train_dataloader_kwargs={"batch_size": 4}, n_iters=4,
                  iter_eval=2, iter_log=2, checkpoint_every=2)
    cfg = base_cli_cfg(*parts, root / "ckpt_mesh", **common,
                       mesh_axes={"data": 2, "model": 1})
    first = _torchrun_cli(dump_cfg(cfg, root / "dp2.yaml"))
    run = _run_dir(root / "ckpt_mesh")
    straight = root / "dp2_final.npz"
    shutil.copy(f"{run}/final_model.npz", straight)
    artifacts = {name: open(f"{run}/{name}").read().splitlines()
                 for name in ("training_metrics.json", "eval_metrics.json")}
    checkpoints = sorted(os.listdir(f"{run}/checkpoints"))
    figures = sorted(f for f in os.listdir(run) if f.endswith(".png"))

    # preemption after step 2's checkpoint; resume on the other mesh
    os.remove(f"{run}/final_model.npz")
    shutil.rmtree(f"{run}/checkpoints/step_4")
    cfg["mesh_axes"] = {"data": 1, "model": 2}
    resumed = _torchrun_cli(dump_cfg(cfg, root / "tp2.yaml"))

    single = base_cli_cfg(*parts, root / "ckpt_single", **common)
    port_main.main(["--p_config", dump_cfg(single, root / "single.yaml"),
                    "--device", "cpu"])
    return dict(straight=straight, resumed=f"{run}/final_model.npz",
                single=f"{_run_dir(root / 'ckpt_single')}/final_model.npz",
                artifacts=artifacts, checkpoints=checkpoints, figures=figures,
                logs=(first.stdout, resumed.stdout))


def test_the_first_rank_alone_writes(runs):
    assert runs["checkpoints"] == ["step_2", "step_4"]
    assert len(runs["artifacts"]["training_metrics.json"]) == 2  # 2 and 4
    assert len(runs["artifacts"]["eval_metrics.json"]) == 2
    assert runs["figures"] == [f"{stem}_{k:05d}.png" for stem in (
        "matched", "queries", "semantic") for k in (2, 4)]
    assert runs["logs"][1].count("resumed train state from") == 1


def test_dp2_run_matches_the_one_rank_run(runs):
    err = _max_rel_err(runs["straight"], runs["single"])
    assert err < 5e-4, f"DP=2 against one rank: rel err {err}"


def test_resume_at_tp2_matches_the_one_rank_run(runs):
    err = _max_rel_err(runs["resumed"], runs["single"])
    assert err < 5e-4, f"resumed at TP=2 against one rank: rel err {err}"
