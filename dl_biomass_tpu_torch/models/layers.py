"""Building-block layers (port of ``dl_biomass_tpu/models/layers.py``).

torch_geometric-style MLPs: per hidden layer Linear -> BatchNorm -> act ->
dropout, with a plain final Linear. Matmul inputs are cast to
``compute_dtype`` (bf16 in production) and multiplied with float32
accumulation; the float32 bias is added before the result is rounded to
``compute_dtype``, in the JAX package's order, and the gradients round where
JAX's do. BatchNorm normalizes by its running statistics in eval and by the
masked batch statistics in training: under ``parallel.data_parallel`` those of
the whole batch, summed over the ranks that share the rows as XLA's SPMD sums
them. The statistics' sums run in float64 over float32 partials of fixed
chunks of each cloud's rows, so that a batch split over ranks gives the
whole batch's statistics to float32's last bit, also where E[x^2] is many
times the variance and the one-pass difference would multiply the sums'
rounding. On the card a train-mode hidden layer with a neighbour mask (the
SA layers', VoxelNet's, the decoder's at 64-row chunks) runs its Dense's
bias add, BatchNorm and activation on kernel 11
(``ops/bn_train_kernel``), where ``bn_train_kernel.takes`` its shapes:
the same values, the statistics to float32's last bit.

``MLP(analytic_bn=True)`` is the folded form of the JAX package's
``MLP._folded``: each hidden layer's train-mode statistics come from its
input's moments and the normalize folds into the layer's matmul.
``MLP(remat=True)`` recomputes the stack in the backward
(``torch.utils.checkpoint``) instead of keeping its activations, as JAX's
``nn.remat`` does; the recompute leaves the running statistics alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from dl_biomass_tpu_torch.ops import bn_train_kernel
from dl_biomass_tpu_torch.ops.sa_train_kernel import fused_sa_mlp
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.utils import profiling

# True while a checkpointed MLP runs its forward again in the backward. A plain
# global, as the mesh is (parallel/mesh.py): autograd runs a CUDA backward on
# a thread of its own
_recomputing = False


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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D operands of one dtype with a float32 product:
    bf16 x bf16 products are exact in float32, so on the card a bf16 GEMM
    with float32 output, and on the CPU a float32 product of the upcast
    operands, is JAX's ``jnp.dot(..., preferred_element_type=float32)``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _DotF32(torch.autograd.Function):
    """The product of ``dot_f32`` with JAX's backward rounding. The cotangent
    of the float32 product comes from a compute-dtype value (the result is
    rounded to it next), so casting it to the compute dtype is exact; each
    gradient is a float32 product rounded once to its operand's dtype, as the
    transpose of ``dot_general`` with ``preferred_element_type`` rounds it."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = _mm_f32(g, w.t()).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(x2.t(), g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., Cin) @ w (Cin, Cout)`` with float32 output, both operands in one
    compute dtype: the JAX package's ``jnp.dot(..., preferred_element_type=float32)``,
    differentiable in both."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _DotF32.apply(x2, w)
    else:
        y = _mm_f32(x2, w)
    return y.view(*shp[:-1], w.shape[-1])


class Dense(nn.Linear):
    """``nn.Linear`` (torch's default init, as the JAX package copies it) with
    compute-dtype matmul inputs and float32 accumulation + bias."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def operands(self, x: torch.Tensor):
        """The product's operands: ``x`` and the (in, out) weight in the
        compute dtype."""
        if x.shape[-1] != self.in_features:
            raise ValueError(
                f"Dense expected {self.in_features} input features, got {x.shape[-1]}")
        cdt = self.compute_dtype
        return x.to(cdt), self.weight.t().to(cdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = dot_f32(*self.operands(x)) + self.bias
        return y.to(self.compute_dtype)


# rows a float32 partial sum of chunk_sums takes at most
CHUNK_ROWS = 64


def chunk_sums(t: torch.Tensor) -> torch.Tensor:
    """(C,) float64 sums of ``t`` (B, ..., C) over every axis but the last:
    float32 sums of chunks of ``gcd(R, CHUNK_ROWS)`` consecutive rows of one
    cloud (R rows a cloud), then their float64 sum. A chunk never crosses a
    cloud, so a slice of the batch has the whole batch's chunk partials, and
    in float64 their sum in another order rounds to the same float32."""
    c = t.shape[-1]
    rows = math.prod(t.shape[1:-1])
    part = t.reshape(-1, math.gcd(rows, CHUNK_ROWS), c).sum(dim=1)
    return part.double().sum(dim=0)


def _count_values(n: int, fused: bool) -> None:
    """While spans are recorded: the counters ``bn.values`` (the values a
    train-mode BatchNorm normalizes) and ``bn.fused`` (those of them on
    kernel 11), host numbers."""
    if profiling.enabled():
        profiling.count("bn.values", n)
        profiling.count("bn.fused", n if fused else 0)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics over valid (mask=True) elements only:
    eps 1e-5, momentum 0.1, the biased variance to normalize and the unbiased
    one for the running estimate. ``x * scale + shift`` in float32, returned
    in the input's dtype.

    In training, where ``bn_train_kernel.takes`` the input, ``forward`` runs
    on kernel 11 (``fused``), else the PyTorch chain (``plain``): the same
    values, the statistics to the last float32 bit."""

    momentum = 0.1

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

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, cnt) -> None:
        """The EMA update with torch semantics (unbiased var for the running
        stat); ``cnt`` is a tensor or a float. Skipped while a checkpointed
        MLP recomputes its forward in the backward: the forward applied it."""
        if _recomputing:
            return
        denom = torch.clamp_min(cnt - 1.0, 1.0) if torch.is_tensor(cnt) else max(cnt - 1.0, 1.0)
        unbiased = var * cnt / denom
        self.running_mean.copy_((1 - self.momentum) * self.running_mean + self.momentum * mean)
        self.running_var.copy_((1 - self.momentum) * self.running_var + self.momentum * unbiased)

    @staticmethod
    def batch_stats(xf: torch.Tensor, mask: Optional[torch.Tensor]):
        """(mean, var, cnt) of float32 ``xf`` over every axis but the last,
        valid slots only: the one-pass ``E[x^2] - mean^2``, clamped at 0, with
        ``cnt = max(sum(mask), 1)`` (the row count without a mask). The sums
        and the difference run in float64 (``chunk_sums``); under a mesh the
        sums and the count are summed over the ranks that share the rows
        first (``parallel.mesh.sum_stats``), differentiably."""
        if mask is not None:
            m = mask.unsqueeze(-1).float()
            xm = xf * m
            cnt = m.sum()
        else:
            xm = xf
            cnt = torch.tensor(float(math.prod(xf.shape[:-1])), device=xf.device)
        sums = dp.sum_stats(torch.cat([chunk_sums(xm), chunk_sums(xm * xf)]), grad=True)
        cnt = torch.clamp_min(dp.sum_stats(cnt), 1.0)
        mean, var, _, _ = bn_train_kernel.statistics(sums, cnt)
        return mean, var, cnt

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if train and self.fusable(x, mask):
            return self.fused(x, mask, None)
        return self.plain(x, mask, train)

    def fusable(self, x: torch.Tensor, mask: Optional[torch.Tensor], act: Optional[str] = None,
                dense: Optional["Dense"] = None, dropout: float = 0.0) -> bool:
        """Whether ``act(self(dense(x), mask, train=True))``, then a dropout
        of ``dropout``, runs on kernel 11 (``fused``): ``bn_train_kernel.takes``
        on the normalized tensor's shape and dtype (``dense`` None: ``x``'s)."""
        shape, dtype = ((x.shape, x.dtype) if dense is None else
                        ((*x.shape[:-1], dense.out_features), dense.compute_dtype))
        return bn_train_kernel.takes(shape, None if mask is None else mask.shape, dtype,
                                     x.device.type, train=True, act=act, dropout=dropout,
                                     mesh=dp.active())

    def plain(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
        """The normalize as a chain of PyTorch operations."""
        if train:
            _count_values(x.numel(), False)
        xf = x.float()
        if train:
            mean, var, cnt = self.batch_stats(xf, mask)
            self.update_running(mean.detach(), var.detach(), cnt)
        else:
            mean, var = self.running_mean, self.running_var
        scale, shift = self.fold(mean, var)
        return (xf * scale + shift).to(x.dtype)

    def fused(self, x: torch.Tensor, mask: torch.Tensor, act: Optional[str],
              dense: Optional["Dense"] = None) -> torch.Tensor:
        """``act(self(dense(x), mask, train=True))`` (``dense`` None: ``x``
        itself) on kernel 11 (``ops/bn_train_kernel.bn_train``), with the
        running statistics' update; for inputs ``bn_train_kernel.takes``.
        ``act`` is a name of ``resolve_activation``."""
        w = bias = None
        if dense is not None:
            x, w = dense.operands(x)
            bias = dense.bias
        out, mean, var, cnt = bn_train_kernel.bn_train(x, mask, self.weight, self.bias,
                                                       eps=self.eps, act=act, w=w, bias=bias)
        self.update_running(mean, var, cnt)
        _count_values(out.numel(), True)
        return out


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout`` rule, ``where(keep, x / (1 - p), 0)``, with the keep
    draws from ``generator`` on x's device (under a mesh, the whole batch's
    draws, of which this rank keeps its rows)."""
    if generator is None:
        raise ValueError("train-mode dropout draws from a torch.Generator: pass generator=")
    keep = dp.rand_rows(x.shape, generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def _recompute():
    global _recomputing
    prev, _recomputing = _recomputing, True
    try:
        yield
    finally:
        _recomputing = prev


def _checkpoint(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward, where the
    running statistics' update is skipped; the recompute runs the same
    operations on the same inputs, so the gradients are the plain call's bit
    for bit. Under a mesh the recompute runs in the forward's mesh context
    and sums the statistics over the same ranks again, on every rank in the
    same order, to the same values."""
    mesh_state = dp.state()

    @contextlib.contextmanager
    def recompute():
        with _recompute(), dp.restored(mesh_state):
            yield

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute()))


class MLP(nn.Module):
    """torch_geometric-style MLP: hidden Linear->BN->act->dropout, plain final
    Linear. ``channels`` includes the input width (``[4, 64, 64, 128]`` for
    SA1); ``dropout`` > 0 (the head's) applies in training only. Submodule
    names (``lin{i}``, ``bn{i}``) follow the JAX parameter tree, so the bridge
    maps it one to one.

    ``analytic_bn``: the folded form (JAX ``MLP._folded``, ``layers.py:268-319``).
    Invalid slots are zeroed before each layer, so the plain moments of the
    layer input ``x`` (``s1 = Σx``, ``M2 = XᵀX``, float32 sums, under a mesh
    over every ``dp`` rank) are its masked moments; the train-mode mean and
    variance of ``y = xW + b`` follow from them, the eval mode takes the
    running ones, and ``(W·scale, b·scale + shift)`` makes the layer's one
    matmul. Dropout (the head's) follows the activation, as in the standard
    form. The JAX package builds that dropout where flax cannot
    (``layers.py:316``), so its analytic model with dropout raises; this one
    runs, with the standard form's draws (ROADMAP C, divergences by design).

    ``remat``: in a train-mode call with gradients, ``forward`` and
    ``from_z0`` keep no activation for the backward and recompute them there
    (JAX's ``nn.remat``, ``pointnet2.py:102-104``)."""

    def __init__(self, channels: Sequence[int], act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 analytic_bn: bool = False, remat: bool = False):
        super().__init__()
        chans = list(channels)
        self.act = act
        self.dropout = dropout
        self.analytic_bn = analytic_bn
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.n_lin = len(chans) - 1
        for i in range(self.n_lin):
            setattr(self, f"lin{i}", Dense(chans[i], chans[i + 1], compute_dtype))
        for i, w in enumerate(chans[1:-1]):
            setattr(self, f"bn{i}", MaskedBatchNorm(w))

    def linears(self):
        return [getattr(self, f"lin{i}") for i in range(self.n_lin)]

    def norms(self):
        return [getattr(self, f"bn{i}") for i in range(self.n_lin - 1)]

    def _post(self, x, lin, bn, mask, act, train, generator):
        """``act(bn(lin(x)))`` (``lin`` None: ``x`` is the layer's output), then
        the training dropout; on kernel 11 where ``bn_train_kernel.takes``
        the layer's output."""
        if train and bn.fusable(x, mask, self.act, lin, self.dropout):
            return bn.fused(x, mask, self.act, lin)
        x = bn.plain(x if lin is None else lin(x), mask, train)
        if act is not None:
            x = act(x)
        if train and self.dropout > 0.0:
            x = dropout(x, self.dropout, generator)
        return x

    def _remat(self, train: bool) -> bool:
        return self.remat and train and torch.is_grad_enabled()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self._remat(train):
            return _checkpoint(self._forward, x, mask, train, generator)
        return self._forward(x, mask, train, generator)

    def _forward(self, x, mask, train, generator):
        act = resolve_activation(self.act)
        lins, bns = self.linears(), self.norms()
        if self.analytic_bn:
            return self._folded(x, mask, lins, bns, act, train, generator)
        for lin, bn in zip(lins[:-1], bns):
            x = self._post(x, lin, bn, mask, act, train, generator)
        return lins[-1](x)

    @staticmethod
    def _count(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The valid slots (the rows without a mask), under a mesh of every
        rank that shares the rows, clamped at 1."""
        if mask is not None:
            cnt = mask.sum().float()
        else:
            cnt = torch.tensor(float(math.prod(x.shape[:-1])), device=x.device)
        return torch.clamp_min(dp.sum_stats(cnt), 1.0)

    @staticmethod
    def _moments(x: torch.Tensor):
        """(s1 (Cin,), M2 (Cin, Cin)) of ``x``, float32 sums; under a mesh
        summed over the ranks that share the rows, differentiably."""
        x2 = x.reshape(-1, x.shape[-1])
        s1 = x2.sum(0, dtype=torch.float32)
        m2 = dot_f32(x2.t(), x2)
        if dp.active() is None:
            return s1, m2
        c = s1.numel()
        sums = dp.sum_stats(torch.cat([s1, m2.reshape(-1)]), grad=True)
        return sums[:c], sums[c:].view(c, c)

    def _folded(self, x, mask, lins, bns, act, train, generator):
        cdt = self.compute_dtype
        mf = None if mask is None else mask.unsqueeze(-1).to(cdt)
        x = x.to(cdt) if mf is None else x.to(cdt) * mf
        cnt = self._count(x, mask) if train else None
        for lin, bn in zip(lins[:-1], bns):
            w, b = lin.weight.t(), lin.bias  # float32 (in, out), (out,)
            if x.shape[-1] != w.shape[0]:
                raise ValueError(f"MLP expected {w.shape[0]} input features, got {x.shape[-1]}")
            if train:
                s1, m2 = self._moments(x)
                sw = s1 @ w
                mean = sw / cnt + b
                quad = (w * (m2 @ w)).sum(0)  # diag(Wᵀ M2 W)
                e2 = (quad + 2.0 * b * sw) / cnt + b * b
                var = torch.clamp_min(e2 - mean * mean, 0.0)
                bn.update_running(mean.detach(), var.detach(), cnt)
            else:
                mean, var = bn.running_mean, bn.running_var
            scale, shift = bn.fold(mean, var)
            y = dot_f32(x, (w * scale).to(cdt)) + (b * scale + shift)
            if act is not None:
                y = act(y)
            if train and self.dropout > 0.0:
                y = dropout(y, self.dropout, generator)
            x = (y if mf is None else y * mf).to(cdt)  # zeros again at invalid slots
        return lins[-1](x)

    def from_z0(self, z0: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Continue the stack from layer 0's pre-BN output ``z0`` (computed by the
        caller, as in SAModule's per-point first-layer split)."""
        if self.analytic_bn:
            raise ValueError("from_z0 is incompatible with analytic_bn (the folded form "
                             "takes its statistics from the layer input, z0 is the output)")
        if self._remat(train):
            return _checkpoint(self._from_z0, z0, mask, train, generator)
        return self._from_z0(z0, mask, train, generator)

    def _from_z0(self, z0, mask, train, generator):
        act = resolve_activation(self.act)
        lins, bns = self.linears(), self.norms()
        if not bns:  # single-linear MLP: z0 is the output
            return z0
        x = self._post(z0, None, bns[0], mask, act, train, generator)
        for lin, bn in zip(lins[1:-1], bns[1:]):
            x = self._post(x, lin, bn, mask, act, train, generator)
        return lins[-1](x)


class FusedSAMLP(MLP):
    """``MLP([C0, C1, C2, C3])`` and the masked max over the 64 neighbour slots,
    run by kernel 6 (``ops/sa_train_kernel.fused_sa_mlp``). The submodules are
    ``MLP``'s (``lin0``, ``bn0``, ``lin1``, ``bn1``, ``lin2``), so the bridge,
    the checkpoints and the serving engine's folding treat it as an ``MLP``.

    ``forward(dense, planes, nbr_mask, train)``: dense (B, M, 64, CD) (cast to
    the compute type) or None, planes (B, M, 64, CP) float32 or None, W1's rows
    ``[dense..., planes...]`` -> pooled (B, M, C3) float32. Train mode uses the
    batch statistics and updates the running ones (torch EMA); eval mode uses
    the running ones. Differentiable in dense and every parameter through
    kernel 6's backward (B1-B3); the planes get no gradient."""

    def __init__(self, channels: Sequence[int], act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32):
        if len(channels) != 4:
            raise ValueError(f"FusedSAMLP needs [C0, C1, C2, C3] channels, got {list(channels)}")
        super().__init__(channels, act=act, compute_dtype=compute_dtype)

    def forward(self, dense: Optional[torch.Tensor], planes: Optional[torch.Tensor],
                nbr_mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        lin0, lin1, lin2 = self.linears()
        bn0, bn1 = self.norms()
        params = dict(w1=lin0.weight.t(), b1=lin0.bias, gamma1=bn0.weight, beta1=bn0.bias,
                      w2=lin1.weight.t(), b2=lin1.bias, gamma2=bn1.weight, beta2=bn1.bias,
                      w3=lin2.weight.t(), b3=lin2.bias)
        bf16 = self.compute_dtype == torch.bfloat16
        if dense is not None:
            dense = dense.to(self.compute_dtype)
        if train:
            out, (m1, v1, m2, v2) = fused_sa_mlp(dense, planes, nbr_mask, params, act=self.act,
                                                 bf16=bf16, train=True)
            cnt = torch.clamp_min(dp.sum_stats(nbr_mask.sum().float()), 1.0)
            bn0.update_running(m1, v1, cnt)
            bn1.update_running(m2, v2, cnt)
            return out
        running = (bn0.running_mean, bn0.running_var, bn1.running_mean, bn1.running_var)
        return fused_sa_mlp(dense, planes, nbr_mask, params, running, act=self.act, bf16=bf16,
                            train=False)
