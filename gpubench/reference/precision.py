"""The arithmetic of the reference's matrix products.

:data:`F32` multiplies float32 operands with TF32 off (:func:`strict`
must have been called). :data:`FP8` is the control: each operand is
rounded to float8 e4m3 under a per-tensor scale (its absolute maximum
over 448, e4m3's largest finite value), the product accumulates in
float32, and its result is rounded to e4m3 again: activations live in fp8 where
the program keeps them in bf16. Gradients pass the rounding straight
through, so the backward's products take the rounded operands of the
forward.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def strict():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _F32:
    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def result(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mm(self, a, b):
        return torch.matmul(a, b)


class _FP8(_F32):
    def operand(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (q - x).detach()

    def result(self, x: torch.Tensor) -> torch.Tensor:
        return self.operand(x)

    def mm(self, a, b):
        return self.result(torch.matmul(self.operand(a), self.operand(b)))


F32 = _F32()
FP8 = _FP8()
