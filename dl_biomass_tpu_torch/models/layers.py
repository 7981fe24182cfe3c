"""Building-block layers (port of ``dl_biomass_tpu/models/layers.py``, eval mode).

torch_geometric-style MLPs: per hidden layer Linear -> BatchNorm -> act, with
a plain final Linear. Matmul inputs are cast to ``compute_dtype`` (bf16 in
production) and multiplied with float32 accumulation; the float32 bias is
added before the result is rounded to ``compute_dtype``, in the JAX package's
order. Train-mode BatchNorm and dropout belong to the training slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def resolve_activation(name: Optional[str]) -> Optional[Callable]:
    """Map the reference's activation names (torch module names) to functions."""
    if name is None or name == "None":
        return None
    table = {
        "ReLU": F.relu,
        "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "ELU": F.elu,
        "GELU": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu default
        "Tanh": torch.tanh,
        "Sigmoid": torch.sigmoid,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}; options: {sorted(table)}")
    return table[name]


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., Cin) @ w (Cin, Cout)`` with float32 output, both operands in one
    compute dtype: bf16 x bf16 products are exact in float32, so this is the
    JAX package's ``jnp.dot(..., preferred_element_type=float32)``."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    if x2.dtype == torch.float32:
        y = x2 @ w
    elif x2.is_cuda:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.view(*shp[:-1], w.shape[-1])


class Dense(nn.Linear):
    """``nn.Linear`` (torch's default init, as the JAX package copies it) with
    compute-dtype matmul inputs and float32 accumulation + bias."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            raise ValueError(
                f"Dense expected {self.in_features} input features, got {x.shape[-1]}")
        cdt = self.compute_dtype
        y = dot_f32(x.to(cdt), self.weight.t().to(cdt)) + self.bias
        return y.to(cdt)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with torch's eval semantics (eps 1e-5): ``x * scale + shift``
    in float32 from the running statistics, returned in the input's dtype.
    The masked batch statistics of train mode come with the training slice."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def fold(self, mean: torch.Tensor, var: torch.Tensor):
        """Fold the normalize into (scale, shift): y = x*scale + shift."""
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.fold(self.running_mean, self.running_var)
        return (x.float() * scale + shift).to(x.dtype)


class MLP(nn.Module):
    """torch_geometric-style MLP: hidden Linear->BN->act, plain final Linear.
    ``channels`` includes the input width (``[4, 64, 64, 128]`` for SA1).
    Dropout, which the head has in training, belongs to the training slice.
    Submodule names (``lin{i}``, ``bn{i}``) follow the JAX parameter tree, so
    ``bridge.from_flax_variables`` maps it one to one."""

    def __init__(self, channels: Sequence[int], act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = list(channels)
        self.act = act
        self.n_lin = len(chans) - 1
        for i in range(self.n_lin):
            setattr(self, f"lin{i}", Dense(chans[i], chans[i + 1], compute_dtype))
        for i, w in enumerate(chans[1:-1]):
            setattr(self, f"bn{i}", MaskedBatchNorm(w))

    def linears(self):
        return [getattr(self, f"lin{i}") for i in range(self.n_lin)]

    def norms(self):
        return [getattr(self, f"bn{i}") for i in range(self.n_lin - 1)]

    def _post(self, x, bn, act):
        x = bn(x)
        return act(x) if act is not None else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = resolve_activation(self.act)
        lins, bns = self.linears(), self.norms()
        for lin, bn in zip(lins[:-1], bns):
            x = self._post(lin(x), bn, act)
        return lins[-1](x)

    def from_z0(self, z0: torch.Tensor) -> torch.Tensor:
        """Continue the stack from layer 0's pre-BN output ``z0`` (computed by the
        caller, as in SAModule's per-point first-layer split)."""
        act = resolve_activation(self.act)
        lins, bns = self.linears(), self.norms()
        if not bns:  # single-linear MLP: z0 is the output
            return z0
        x = self._post(z0, bns[0], act)
        for lin, bn in zip(lins[1:-1], bns[1:]):
            x = self._post(lin(x), bn, act)
        return lins[-1](x)
