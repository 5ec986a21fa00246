"""PyTorch/CUDA port of zutis_tpu for NVIDIA Hopper.

A package beside the JAX one, which stays the reference. It imports torch,
numpy and the standard library only, never JAX or anything of zutis_tpu; the
JAX-free helpers it needs are its own copies. Its kernels are hand-written
CUDA C++ for sm_90a (csrc/), and its RLE codec and image library host C++
(native/), each built at first use.

Entry points (`ZUTIS`, `InferenceServer`, `evaluate_instances`, `Trainer`,
and the CLIs `python -m zutis_tpu_torch.cli.main` and
`python -m zutis_tpu_torch.cli.coco20k_eval`) run on device="cuda" unless
the caller passes device="cpu"; without a card, asking for CUDA raises.
Images are read by the port's own JPEG/PNG decoder and augmented without
Pillow or OpenCV (native/image.cc, data/).
"""
from zutis_tpu_torch.engine.batched_eval import evaluate_instances
from zutis_tpu_torch.engine.server import InferenceServer
from zutis_tpu_torch.engine.trainer import Trainer
from zutis_tpu_torch.models.zutis import ZUTIS

__all__ = ["InferenceServer", "Trainer", "ZUTIS", "evaluate_instances"]
