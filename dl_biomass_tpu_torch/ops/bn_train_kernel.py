"""Kernel 11: the train-mode masked BatchNorm of an SA MLP's hidden layer,
fused with the bias add and the rounding of the ``Dense`` before it and the
activation after it, forward and backward (``csrc/bn_train.cu``).

``models/layers.py`` runs this step as a chain of PyTorch operations, each a
pass over the (B, M, 64, C) edge tensor: the bias add and the cast of
``Dense``, the casts, mask products and chunk sums of
``MaskedBatchNorm.batch_stats``, the normalize, the activation, and
autograd's backward of each. Four passes over the (rows, C) rows, 64 rows
(one centroid's neighbour slots) a chunk, do the same arithmetic:

  F1 ``f1``: y = round(z + b) from the GEMM's float32 product z (or y as
     given, read only); per chunk the float32 sums of y m and (y m) y
  F2 ``f2``: out = act(round(y scale + shift))
  B1 ``b1``: g = act'(o) dout with o = round(y scale + shift); per chunk
     the sums of g and g (y - mean)
  B2 ``b2``: dy = round(g scale + m (d1 + d2 y) + d2 (y m)); per chunk the
     sums of dy, the bias's gradient, where there is a bias

round() is to the compute dtype, m the row mask as 0.0 or 1.0. Between F1
and F2 the chunk partials are added in float64 (``sum_slices``, as
``chunk_sums`` adds them) and the (C,) statistics follow as
``MaskedBatchNorm.batch_stats`` and ``fold`` make them: ``mean = s1 / cnt``,
``var = max(s2 / cnt - mean^2, 0)`` in float64, rounded to float32, ``cnt =
max(sum(mask), 1)``, ``scale = gamma rsqrt(var + eps)``, ``shift = beta -
mean scale``. Between B1 and B2 autograd's backward of those few (C,)
operations is written out (``_coefficients``): d1 and d2 are the gradients
of the chunk sums of y m and of (y m) y. So F1's y and F2's output are the
plain chain's bit for bit where the statistics agree, and they agree to the
last float32 bit (the chunk's float32 sum runs in another order). The
gradients differ from autograd's by rounding: autograd sums ``g`` and ``g
y`` over the rows in float32 and takes ``g y - g mean`` after; B1 sums ``g
(y - mean)`` in float32 chunks, then float64.

``BNTrain`` ties the passes together as a ``torch.autograd.Function``; the
product ``x @ w`` with its float32 output and its backward's rounding is
``dot_f32``'s (``sa_eval_kernel._dot_f32``), so the GEMMs are the plain
path's and only their float32 output is not kept. ``bn_train`` is its entry.
Each pass launches its kernel on a CUDA tensor and runs its plain version
(``f1_plain``, ...) on a CPU one; ``takes`` is the rule by which the models
call ``bn_train`` at all: on the card only, so the CPU runs the plain chain.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.sa_eval_kernel import _dot_f32
from dl_biomass_tpu_torch.ops.sa_train_kernel import ACTS
from dl_biomass_tpu_torch.ops.sum_slices_kernel import sum_slices

CHUNK = 64  # rows a chunk partial sums: layers.CHUNK_ROWS, one centroid's slots
WIDTHS = (8, 16, 32, 64, 128, 256, 512)  # the channel counts the kernels take
DTYPES = (torch.bfloat16, torch.float32)
LEAKY_SLOPE = 0.01  # layers.resolve_activation's LeakyReLU

_P = ctypes.c_void_p
_I = ctypes.c_int
_STATS_ARGS = [_P] * 5 + [_I] * 3 + [_P]
_APPLY_ARGS = [_P] * 4 + [_I] * 4 + [_P]
_GRAD_SUMS_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_GRAD_ARGS = [_P] * 9 + [_I] * 4 + [_P]


def takes(shape, mask_shape, dtype: torch.dtype, device_type: str, *, train: bool,
          act: Optional[str], dropout: float, mesh) -> bool:
    """Whether the BatchNorm of a hidden layer whose (pre-normalize) output has
    ``shape`` runs on these kernels: in training on the card, with a mask of
    that shape less its channels, in bf16 or float32, outside a mesh
    (``mesh``: ``parallel.mesh.active()``), with no dropout after it, one of
    kernel 6's four activations, a channel count of ``WIDTHS``, and rows a
    cloud (every axis between the first and the channels) a multiple of
    ``CHUNK``, so that ``chunk_sums`` takes chunks of ``CHUNK`` rows."""
    if not (device_type == "cuda" and train and mask_shape is not None and mesh is None
            and dropout == 0.0 and act in ACTS and dtype in DTYPES):
        return False
    shape, mask_shape = tuple(shape), tuple(mask_shape)
    if len(shape) != len(mask_shape) + 1 or shape[:-1] != mask_shape:
        return False
    rows = math.prod(shape[1:-1])
    return (shape[-1] in WIDTHS and shape[0] > 0 and rows > 0
            and math.gcd(rows, CHUNK) == CHUNK)


def _acc(t: torch.Tensor) -> torch.dtype:
    """The type sums and products of ``t``'s values run in: float64 for float64
    (the CPU tests' mirror), else float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _chunks(t: torch.Tensor) -> torch.Tensor:
    """(rows, C) -> the sums of each chunk's rows, (rows / CHUNK, C)."""
    return t.view(-1, CHUNK, t.shape[-1]).sum(1)


def _act(o: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    code = ACTS[act]
    if code == 1:
        return F.relu(o)
    if code == 2:
        return F.leaky_relu(o, negative_slope=LEAKY_SLOPE)
    if code == 3:
        return F.elu(o)
    return o


def _act_grad(o: torch.Tensor, g: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The gradient of ``o`` from the gradient ``g`` of ``_act(o, act)``, as
    autograd computes it on ``o``'s dtype: in float32, rounded once."""
    code = ACTS[act]
    if code == 0:
        return g
    if code == 1:  # threshold_backward on the result: NaN passes
        return torch.where((o > 0) | o.isnan(), g, torch.zeros_like(g))
    of, gf = o.to(_acc(o)), g.to(_acc(g))
    if code == 2:
        return torch.where(o > 0, gf, gf * LEAKY_SLOPE).to(g.dtype)
    return torch.where(o <= 0, gf * torch.exp(of), gf).to(g.dtype)


def _normalized(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """o = round(y scale + shift), the product and the sum each rounded."""
    return (y.to(_acc(y)) * scale + shift).to(y.dtype)


def f1_plain(x: torch.Tensor, bias: Optional[torch.Tensor], mask: torch.Tensor,
             dtype: torch.dtype) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """F1's plain version: ``(y, partials)``, ``y = (x + bias).to(dtype)`` for
    ``x`` the float32 product (None where ``bias`` is None: ``x`` is y), the
    partials (rows / CHUNK, 2C) the sums of y m, then of (y m) y, in float32
    (float64 for float64 y)."""
    y = x if bias is None else (x + bias).to(dtype)
    yf = y.to(_acc(y))
    ym = yf * mask.view(-1, 1).to(yf.dtype)
    return (None if bias is None else y), torch.cat([_chunks(ym), _chunks(ym * yf)], 1)


def f2_plain(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             act: Optional[str]) -> torch.Tensor:
    """F2's plain version: act(round(y scale + shift)) in y's dtype."""
    return _act(_normalized(y, scale, shift), act)


def b1_plain(dout: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             mean: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """B1's plain version: the partials (rows / CHUNK, 2C), the sums of g, then
    of g (y - mean), g the gradient of the normalized value."""
    g = _act_grad(_normalized(y, scale, shift), dout, act).to(_acc(y))
    return torch.cat([_chunks(g), _chunks(g * (y.to(g.dtype) - mean))], 1)


def b2_plain(dout: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
             shift: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor, act: Optional[str],
             bias_sums: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B2's plain version: ``(dy, partials)``, dy = round(g scale + m (d1 + d2
    y) + d2 (y m)) in y's dtype and, where ``bias_sums``, the sums of dy
    (rows / CHUNK, C)."""
    g = _act_grad(_normalized(y, scale, shift), dout, act).to(_acc(y))
    yf = y.to(g.dtype)
    m = mask.view(-1, 1).to(g.dtype)
    dy = (g * scale + (d1 + d2 * yf) * m + d2 * (yf * m)).to(y.dtype)
    return dy, (_chunks(dy.to(g.dtype)) if bias_sums else None)


def _launch(name: str, entry: str, argtypes, vectors, *args) -> None:
    """Check what a launch reads and writes (one card, contiguous; the
    ``vectors``, which the kernel reads 16 bytes at a time, on 16 bytes) and
    launch ``entry`` with ``args`` (tensors as their pointers, None as a null
    pointer) on the current stream."""
    tensors = [a for a in args if torch.is_tensor(a)]
    _build.check_cuda(name, *tensors)
    if any(t.data_ptr() % 16 for t in vectors):
        raise ValueError(f"{name}: the kernel reads 16-byte vectors; a tensor is not on 16 bytes")
    _build.launch(entry, argtypes, *(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                  _build.stream_of(tensors[0]))


def _chunks_of(shape, dtype: torch.dtype) -> int:
    """The chunks of a (rows, C) tensor of ``dtype`` the kernels take."""
    rows, c = shape
    if c not in WIDTHS or rows % CHUNK or dtype not in DTYPES:
        raise ValueError(f"bn_train kernels take (rows, C) bf16 or float32 with C in {WIDTHS} "
                         f"and rows a multiple of {CHUNK}, got {tuple(shape)} {dtype}")
    return rows // CHUNK


def f1(x: torch.Tensor, bias: Optional[torch.Tensor], mask: torch.Tensor,
       dtype: torch.dtype) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """F1 (``dlbt_bn_stats``), as ``f1_plain``: ``x`` (rows, C) float32 with
    ``bias``, or y in ``dtype``; ``mask`` (rows,) bool."""
    if x.device.type == "cpu":
        return f1_plain(x, bias, mask, dtype)
    dense = bias is not None
    if x.dtype != (torch.float32 if dense else dtype):
        raise ValueError(f"F1 takes the float32 product with a bias, else y, got {x.dtype}")
    chunks, c = _chunks_of(x.shape, dtype), x.shape[1]
    y = torch.empty(x.shape, dtype=dtype, device=x.device) if dense else None
    part = torch.empty((chunks, 2 * c), dtype=torch.float32, device=x.device)
    _launch("bn_train F1", "dlbt_bn_stats", _STATS_ARGS,
            [t for t in (x, y, part) if t is not None], x, bias, y, mask, part, chunks, c,
            int(dtype == torch.bfloat16))
    return y, part


def f2(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
       act: Optional[str]) -> torch.Tensor:
    """F2 (``dlbt_bn_apply``), as ``f2_plain``."""
    if y.device.type == "cpu":
        return f2_plain(y, scale, shift, act)
    chunks, c = _chunks_of(y.shape, y.dtype), y.shape[1]
    out = torch.empty_like(y)
    _launch("bn_train F2", "dlbt_bn_apply", _APPLY_ARGS, [y, out], y, scale, shift, out, chunks,
            c, int(y.dtype == torch.bfloat16), ACTS[act])
    return out


def b1(dout: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
       mean: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """B1 (``dlbt_bn_grad_sums``), as ``b1_plain``."""
    if y.device.type == "cpu":
        return b1_plain(dout, y, scale, shift, mean, act)
    chunks, c = _chunks_of(y.shape, y.dtype), y.shape[1]
    part = torch.empty((chunks, 2 * c), dtype=torch.float32, device=y.device)
    _launch("bn_train B1", "dlbt_bn_grad_sums", _GRAD_SUMS_ARGS, [dout, y, part], dout, y, scale,
            shift, mean, part, chunks, c, int(y.dtype == torch.bfloat16), ACTS[act])
    return part


def b2(dout: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
       shift: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor, act: Optional[str],
       bias_sums: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B2 (``dlbt_bn_grad``), as ``b2_plain``."""
    if y.device.type == "cpu":
        return b2_plain(dout, y, mask, scale, shift, d1, d2, act, bias_sums)
    chunks, c = _chunks_of(y.shape, y.dtype), y.shape[1]
    dy = torch.empty_like(y)
    part = (torch.empty((chunks, c), dtype=torch.float32, device=y.device) if bias_sums
            else None)
    _launch("bn_train B2", "dlbt_bn_grad", _GRAD_ARGS,
            [t for t in (dout, y, dy, part) if t is not None], dout, y, mask, scale, shift, d1,
            d2, dy, part, chunks, c, int(y.dtype == torch.bfloat16), ACTS[act])
    return dy, part


def statistics(sums: torch.Tensor, cnt: torch.Tensor):
    """(mean, var) float32 and the float64 mean and unclamped variance from the
    float64 sums (2C,) of y m and (y m) y over ``cnt`` valid rows, as
    ``MaskedBatchNorm.batch_stats`` computes them."""
    c = sums.numel() // 2
    mean64 = sums[:c] / cnt
    var_raw = sums[c:] / cnt - mean64 * mean64
    return mean64.float(), torch.clamp_min(var_raw, 0.0).float(), mean64, var_raw


def _coefficients(sums: torch.Tensor, gamma, mean64, var_raw, var, scale, cnt, eps: float,
                  acc: torch.dtype):
    """(dgamma, dbeta, d1, d2) from B1's float64 sums (2C,) of g and g (y -
    mean): autograd's backward of ``statistics`` and ``fold`` written out,
    with d1 and d2 the gradients of the sums of y m and of (y m) y, in the
    type ``acc`` of the row sums (``chunk_sums``' ``.double()`` casts them
    back to it)."""
    c = sums.numel() // 2
    sg, sgx = sums[:c], sums[c:]
    r = torch.rsqrt(var + eps)  # as fold computes it: scale = gamma r
    dvar = torch.where(var_raw >= 0.0, sgx * gamma * (-0.5) * r * r * r, 0.0)  # clamp_min
    d1 = (-sg * scale - 2.0 * mean64 * dvar) / cnt
    d2 = dvar / cnt
    return (sgx * r).to(gamma.dtype), sg.to(gamma.dtype), d1.to(acc), d2.to(acc)


class BNTrain(torch.autograd.Function):
    """act(BatchNorm(y)) in training on the four passes, y = round(x @ w + bias)
    or y = x. The forward keeps x and w (for the product's gradients), y, the
    mask, the statistics, scale, shift and the count, no float32 copy of a
    row; mean, var and the count are outputs without a gradient."""

    @staticmethod
    def forward(ctx, x, w, bias, gamma, beta, mask, eps: float, act: Optional[str]):
        dense = w is not None
        if dense:
            y, part = f1(_dot_f32(x, w), bias, mask, x.dtype)
        else:
            y, (_, part) = x, f1(x, None, mask, x.dtype)
        cnt = torch.clamp_min(mask.sum().to(torch.float32), 1.0)
        mean, var, mean64, var_raw = statistics(sum_slices(part, torch.float64), cnt)
        scale = gamma * torch.rsqrt(var + eps)
        shift = beta - mean * scale
        out = f2(y, scale, shift, act)
        ctx.save_for_backward(x if dense else None, w, y, mask, gamma, mean, var, mean64, var_raw,
                              scale, shift, cnt)
        ctx.eps, ctx.act, ctx.bias_dtype = eps, act, None if bias is None else bias.dtype
        ctx.mark_non_differentiable(mean, var, cnt)
        return out, mean, var, cnt

    @staticmethod
    def backward(ctx, dout, *_):
        x, w, y, mask, gamma, mean, var, mean64, var_raw, scale, shift, cnt = ctx.saved_tensors
        act, dense = ctx.act, w is not None
        dout = dout.contiguous()
        sums = sum_slices(b1(dout, y, scale, shift, mean, act), torch.float64)
        dgamma, dbeta, d1, d2 = _coefficients(sums, gamma, mean64, var_raw, var, scale, cnt,
                                              ctx.eps, _acc(y))
        dy, part = b2(dout, y, mask, scale, shift, d1, d2, act, bias_sums=dense)
        if not dense:
            return dy, None, None, dgamma, dbeta, None, None, None
        need = ctx.needs_input_grad
        dx = _dot_f32(dy, w.t()).to(x.dtype) if need[0] else None
        dw = _dot_f32(x.t(), dy).to(w.dtype) if need[1] else None
        dbias = sum_slices(part, torch.float64).to(ctx.bias_dtype)
        return dx, dw, dbias, dgamma, dbeta, None, None, None


def bn_train(x: torch.Tensor, mask: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
             eps: float, act: Optional[str], w: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None):
    """``(act(BatchNorm(y)), mean, var, cnt)`` with the batch statistics of
    the valid rows: y = round(x @ w + bias) to x's dtype where ``w`` (Cin, C)
    is given (x (..., Cin), w in x's dtype, bias (C,) float32; ``dot_f32``'s
    product), else y = x (..., C). ``mask`` has x's shape less its channels;
    mean and var (float32) and cnt are for the caller's running update.
    Differentiable in x, w, bias, gamma and beta."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out, mean, var, cnt = BNTrain.apply(x2, w, bias, gamma, beta, mask.reshape(-1).contiguous(),
                                        eps, act)
    return out.view(*lead, out.shape[-1]), mean, var, cnt
