"""The operand precision of the reference's products.

"fp32" is the reference: every product of a linear layer, a convolution and
an attention takes its operands as they are, in float32 (TF32 off, see
`strict_fp32`). "fp8" is the control: the same network with each operand
of those products rounded to float8 e4m3 under a per-tensor scale (its
abs-max maps to 448, e4m3's largest finite value), the precision one step
below the bfloat16 the configurations state. Sums stay in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
MODES = ("fp32", "fp8")


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in this precision (float32 out)."""
        x = x.float()
        if self.mode == "fp32":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, weight, bias=None):
        return F.linear(self.q(x), self.q(weight), None if bias is None else bias.float())

    def conv(self, x_nhwc, weight, bias=None, stride=1, padding=0):
        """A convolution of an NHWC tensor with an OIHW weight."""
        y = F.conv2d(self.q(x_nhwc).permute(0, 3, 1, 2), self.q(weight),
                     None if bias is None else bias.float(), stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def attention(P: Precision, q, k, v, budget_bytes: int = 1 << 29) -> torch.Tensor:
    """Softmax attention, (B, H, L, D) x (B, H, S, D) -> (B, H, L, D), in
    blocks of query rows so that a block's scores stay under `budget_bytes`.
    Every block sees all S keys: the softmax is exact, not online. Under
    autograd each block is recomputed in the backward, so no block's scores
    outlive it."""
    B, H, L, D = q.shape
    S = k.shape[2]
    rows = max(1, budget_bytes // (H * S * 4))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))

    def block(qb, kb, vb):
        s = P.matmul(qb, kb.transpose(-1, -2)) * D**-0.5
        return P.matmul(torch.softmax(s, dim=-1), vb)

    out = []
    for b in range(B):
        kb, vb = k[b : b + 1], v[b : b + 1]
        qs = [q[b : b + 1, :, r0 : r0 + rows] for r0 in range(0, L, rows)]
        out.append(torch.cat([checkpoint(block, qb, kb, vb, use_reentrant=False) if grad else block(qb, kb, vb)
                              for qb in qs], dim=2))
    return torch.cat(out)
