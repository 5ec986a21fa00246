"""PyTorch/CUDA port of zutis_tpu for NVIDIA Hopper.

A package beside the JAX one, which stays the reference. It imports torch,
numpy and the standard library only, never JAX or anything of zutis_tpu; the
JAX-free helpers it needs are its own copies. The attention kernel is
hand-written CUDA C++ for sm_90a (csrc/), built at first use.

Entry points (`ZUTIS`, `InferenceServer`) run on device="cuda" unless the
caller passes device="cpu"; without a card, asking for CUDA raises.
"""
from zutis_tpu_torch.engine.server import InferenceServer
from zutis_tpu_torch.models.zutis import ZUTIS

__all__ = ["InferenceServer", "ZUTIS"]
