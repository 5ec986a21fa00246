"""The precision the plain reference computes its products in.

`Precision()` is the reference itself: float32 operands, with TF32 off
(the harness turns it off for the whole process). `Precision("fp8")` is the
control: every operand of a product that the program computes in bfloat16
is first rounded to float8 e4m3 with a scale of its own (its largest
magnitude over 448, e4m3's largest normal), the step below the
configuration's bfloat16; the product is then taken in float32 on the
rounded values. The rounding passes gradients straight through, so that
the control trains as the reference does.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r} is fp32 or fp8")
        self.kind = kind

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
            q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)
