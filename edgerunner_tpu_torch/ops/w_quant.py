"""Weight-only int8 quantisation of the decoder's projections (--w_quant),
the port of edgerunner_tpu/ops/w_quant.py:31-122.

Each projection kernel is stored as int8 with one f32 absmax/127 scale per
output column; the product runs on the values converted to the activation
dtype and the scale multiplies the result, since x·(W·diag(s)) = (x·W)·s.
The JAX package leaves that product to XLA, outside any Pallas kernel, so
here it is a PyTorch matmul. Two differences from the JAX package follow
from that: a bf16 matmul returns bf16, so the scale applies after a
rounding to bf16 that JAX's f32-output dot does not make (the f32 path is
the same function); and the int8 values are converted to the activation
dtype on every call, which moves more bytes than bf16 weights would (a
fused int8-weight GEMM is later work).

As in the JAX package the exact weights are loaded first and quantised
after (`quantize_lmm_params`); `lm_head` stays exact. Under `moe_experts`
the layers hold no fc1/fc2, so only the attention projections are
quantised, as the JAX walk over `_QUANT_LEAF_NAMES` finds no others
(w_quant.py:92-123): the router and the stacked experts stay exact. LoRA
with `--w_quant` is refused (config.py `validate`): merge the adapters
first (`python -m edgerunner_tpu_torch.merge_lora`).
"""

from __future__ import annotations

import torch
from torch import nn

# the projections quantised inside the mesh decoder (w_quant.py:93-99)
QUANT_NAMES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def quantize_kernel(kernel: torch.Tensor):
    """[in, out] float kernel (the JAX package's layout) -> (int8 values
    [in, out], f32 [out] per-column scales)."""
    k = kernel.float()
    scale = torch.clamp(k.abs().amax(dim=0), min=1e-8) / 127.0
    q = torch.clamp(torch.round(k / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale[None, :].float()).to(dtype)


class QuantDense(nn.Module):
    """A linear layer with an int8 kernel [in, out] (`kernel_q`) and f32
    per-column scales (`scale`), and the bias of the layer it replaces."""

    def __init__(self, kernel_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor = None):
        super().__init__()
        self.register_buffer("kernel_q", kernel_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "QuantDense":
        q, s = quantize_kernel(linear.weight.detach().t())
        bias = None if linear.bias is None else linear.bias.detach().clone()
        return cls(q, s, bias)

    def forward(self, x):
        y = torch.matmul(x, self.kernel_q.to(x.dtype)).float() * self.scale
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


@torch.no_grad()
def quantize_lmm_params(model: nn.Module) -> nn.Module:
    """Replace, in place, the q/k/v/out and fc1/fc2 projections of the LMM's
    mesh decoder with `QuantDense` layers quantised from their weights
    (w_quant.py:102-122). The conditioner, embeddings, LayerNorms,
    `lm_head` and a MoE layer (router and experts) stay exact. Returns the
    model."""
    decoder = model.mesh_decoder
    for parent in list(decoder.modules()):
        for child_name, child in list(parent.named_children()):
            if child_name in QUANT_NAMES and type(child) is nn.Linear:
                setattr(parent, child_name, QuantDense.from_linear(child))
    return model
