"""zutis_tpu_torch stands alone: in a fresh interpreter where importing jax,
flax, PIL, yaml, cv2, matplotlib, scipy or zutis_tpu fails (the card's
machine has none of the first six, and the port does not lean on scipy),
the package and every submodule import."""
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "PIL", "yaml", "cv2",
           "matplotlib", "scipy", "zutis_tpu")


class Blocker:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import zutis_tpu_torch

names = [m.name for m in pkgutil.walk_packages(zutis_tpu_torch.__path__,
                                               "zutis_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names))
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


# the eval slice's modules, which the walk above must reach
EVAL_SLICE = ("zutis_tpu_torch.ops.dynamic_shapes",
              "zutis_tpu_torch.ops.rle_device",
              "zutis_tpu_torch.engine.batched_eval",
              "zutis_tpu_torch.engine.coco_eval",
              "zutis_tpu_torch.data.coco_api",
              "zutis_tpu_torch.tools.instance_eval_bench")


# the trainer slice's modules: the codec, the config with its YAML parser,
# checkpoints, profiling, the data tables and the Trainer
TRAINER_SLICE = ("zutis_tpu_torch.native",
                 "zutis_tpu_torch.core.config",
                 "zutis_tpu_torch.core.checkpoint",
                 "zutis_tpu_torch.core.profiling",
                 "zutis_tpu_torch.data.label_maps",
                 "zutis_tpu_torch.data.category_lists",
                 "zutis_tpu_torch.engine.trainer")


# the data slice's modules: the image library and decoder, the resampler,
# augmentations, datasets, the ViT factory and the two CLIs
DATA_SLICE = ("zutis_tpu_torch.native.image",
              "zutis_tpu_torch.data.image_io",
              "zutis_tpu_torch.data.transforms",
              "zutis_tpu_torch.data.augment",
              "zutis_tpu_torch.data.advanced_copy_paste",
              "zutis_tpu_torch.data.index_dataset",
              "zutis_tpu_torch.data.imagenet_index",
              "zutis_tpu_torch.data.pseudo_masks",
              "zutis_tpu_torch.data.datasets",
              "zutis_tpu_torch.models.factory",
              "zutis_tpu_torch.cli.main",
              "zutis_tpu_torch.cli.coco20k_eval")


# the retrieval slice's modules: the tokenizer, the text tower, the
# prompts, the text and image embeddings and the bank's top-k
RETRIEVAL_SLICE = ("zutis_tpu_torch.data.tokenizer",
                   "zutis_tpu_torch.models.text",
                   "zutis_tpu_torch.models.weights",
                   "zutis_tpu_torch.retrieval",
                   "zutis_tpu_torch.retrieval.prompts",
                   "zutis_tpu_torch.retrieval.text_embeddings",
                   "zutis_tpu_torch.retrieval.image_embeddings",
                   "zutis_tpu_torch.retrieval.bank")


# the pseudo-labelling slice's modules: SelfMask, the bilateral solver, the
# host fill and labelling, the generator
PSEUDO_MASK_SLICE = ("zutis_tpu_torch.models.selfmask",
                     "zutis_tpu_torch.ops.bilateral",
                     "zutis_tpu_torch.native.labels",
                     "zutis_tpu_torch.data.pseudo_masks")


# the parallel layer: the mesh and its sharding, DP's gradient reduction,
# TP's collectives, sequence parallelism and the tool that drives them
PARALLEL_SLICE = ("zutis_tpu_torch.parallel",
                  "zutis_tpu_torch.parallel.mesh",
                  "zutis_tpu_torch.parallel.dp",
                  "zutis_tpu_torch.parallel.tp",
                  "zutis_tpu_torch.parallel.sp",
                  "zutis_tpu_torch.tools.parallel_check")


def test_port_imports_without_jax_flax_pil_or_zutis_tpu():
    proc = _run(_PROBE.replace('print("imported", len(names))',
                               'print(*names)\nprint("imported", len(names))'))
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[-1])
    assert n >= 40, proc.stdout
    assert set(EVAL_SLICE) <= set(proc.stdout.split()), proc.stdout
    assert set(TRAINER_SLICE) <= set(proc.stdout.split()), proc.stdout
    assert set(DATA_SLICE) <= set(proc.stdout.split()), proc.stdout
    assert set(RETRIEVAL_SLICE) <= set(proc.stdout.split()), proc.stdout
    assert set(PSEUDO_MASK_SLICE) <= set(proc.stdout.split()), proc.stdout
    assert set(PARALLEL_SLICE) <= set(proc.stdout.split()), proc.stdout


@pytest.mark.parametrize("name", ["cv2", "matplotlib", "yaml", "scipy"])
def test_blocker_blocks_what_the_card_lacks(name):
    proc = _run(_PROBE.replace("import zutis_tpu_torch\n",
                               f"import zutis_tpu_torch\nimport {name}\n"))
    assert proc.returncode != 0
    assert f"blocked import of {name}" in proc.stderr


def test_blocker_really_blocks():
    proc = _run(_PROBE.replace("import zutis_tpu_torch\n",
                               "import zutis_tpu_torch\nimport zutis_tpu\n"))
    assert proc.returncode != 0
    assert "blocked import of zutis_tpu" in proc.stderr
