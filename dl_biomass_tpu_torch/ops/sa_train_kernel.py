"""Kernel 6's forward: the fused SA-layer MLP and masked max (port of the
forward passes of ``dl_biomass_tpu/ops/pallas_sa_train.py`` fused_sa_mlp).

An SA layer's edge MLP ``[C0, C1, C2, C3]`` (Linear, BatchNorm, act, twice,
then Linear) and its masked max over the 64 neighbour slots, computed by
three recomputing passes that keep every hidden value on chip:

  F1: h1 = [dense, planes] W1 + b1; masked column sums and sums of squares
  F2: recompute h1; a1 = act(h1 sc1 + sh1); h2 = a1 W2 + b2; the same sums of h2
  F3: recompute to h3 = a2 W3 + b3; masked max over the slots and first argmax

with the batch statistics (train) or the running ones (eval) folded into
(sc, sh) between the passes. The numerics are the JAX function's: one-pass
statistics ``mean = s / cnt``, ``var = max(ss / cnt - mean^2, 0)`` with
``cnt = max(sum(nbr_mask), 1)``, eps 1e-5; in bf16 mode each product takes
bf16-rounded operands with float32 accumulation while h1, a1, h2 and a2 stay
float32 (unlike the unfused ``MLP``, which rounds every layer's output); in
float32 mode plain float32 products. The output is float32, 0 (argmax -1)
where a centroid has no valid slot.

``fused_sa_stage`` is one pass: it launches ``csrc/fused_sa_fwd.cu`` (entries
``dlbt_fused_sa_f1``, ``_f2``, ``_f3``) on a CUDA tensor and runs
``fused_sa_stage_plain`` on a CPU tensor. ``fused_sa_mlp`` chains the passes as
the JAX function does; ``fused_sa_mlp_plain`` chains the plain passes. The
kernel sums in its own order (float32 FMAs per row, float64 across rows), so
it agrees with the plain version to float32 rounding of the sums (bf16: an
activation near a rounding boundary may round one step the other way).

The planes arrive as one (B, M, 64, CP) float32 tensor (kernel 2's edges at
SA1, the centroid-relative positions at SA2) where the JAX package passes CP
(B, M, 64) planes, a TPU layout. The backward passes (B1-B3) are not ported
yet: a call that autograd would have to differentiate raises
``NotImplementedError`` on every device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from dl_biomass_tpu_torch.core.cloud import round_up
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.pooling import first_argmax
from dl_biomass_tpu_torch.ops.sa_eval_kernel import _dot_f32

K = 64  # neighbour slots
EPS = 1e-5
WIDTH_STEP = 64  # the kernel's layer widths are multiples of 64 (zero-padded)
MAX_GRID = 1024  # blocks of the kernel at most: the rows of F1's and F2's scratch
ACTS = {None: 0, "None": 0, "ReLU": 1, "LeakyReLU": 2, "ELU": 3}
ENTRIES = {1: "dlbt_fused_sa_f1", 2: "dlbt_fused_sa_f2", 3: "dlbt_fused_sa_f3"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
BACKWARD_MISSING = ("the backward of the fused SA MLP (kernel 6's B1-B3) is not ported yet "
                    "(ROADMAP A, Next item 1b): run a fused_sa model under torch.no_grad() or "
                    "torch.inference_mode()")

Folds = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _check_act(name: Optional[str]) -> None:
    if name not in ACTS:
        raise ValueError(f"fused SA kernel: unsupported activation {name!r}")


def _act(z: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    _check_act(name)
    if ACTS[name] == 1:
        return torch.clamp_min(z, 0.0)
    if ACTS[name] == 2:
        return torch.where(z > 0, z, 0.01 * z)
    if ACTS[name] == 3:
        return torch.where(z > 0, z, torch.exp(torch.clamp_max(z, 0.0)) - 1.0)
    return z


def _widths(dense, planes, nbr_mask, params):
    b, m, k = nbr_mask.shape
    if k != K:
        raise ValueError(f"fused SA kernel: {K} neighbour slots, got {k}")
    cd = 0 if dense is None else dense.shape[-1]
    cp = 0 if planes is None else planes.shape[-1]
    for name, x, c in (("dense", dense, cd), ("planes", planes, cp)):
        if x is not None and tuple(x.shape) != (b, m, k, c):
            raise ValueError(f"{name} must be (B, M, {K}, C) beside nbr_mask "
                             f"{tuple(nbr_mask.shape)}, got {tuple(x.shape)}")
    if params["w1"].shape[0] != cd + cp:
        raise ValueError(f"w1 expects {params['w1'].shape[0]} input channels, got dense {cd} "
                         f"+ planes {cp}")
    return cd, cp


def hidden_plain(layer: int, dense, planes, nbr_mask, params: dict, folds: Folds = (), *,
                 act: Optional[str] = "ReLU", bf16: bool = False) -> torch.Tensor:
    """h1, h2 or h3 (``layer`` 1, 2, 3) of every edge row, (B*M*64, C) float32:
    the chain the passes recompute, with ``folds`` = [(sc1, sh1), (sc2, sh2)]."""
    cd, cp = _widths(dense, planes, nbr_mask, params)
    _check_act(act)
    ct = torch.bfloat16 if bf16 else torch.float32

    def dot(x, w):
        return _dot_f32(x.reshape(-1, x.shape[-1]).to(ct), w.to(ct))

    w1 = params["w1"]
    h = dot(planes.float(), w1[cd:]) if cp else 0.0
    if cd:
        h = h + dot(dense, w1[:cd])
    h = h + params["b1"]
    for i in range(2, layer + 1):
        sc, sh = folds[i - 2]
        h = dot(_act(h * sc + sh, act), params[f"w{i}"]) + params[f"b{i}"]
    return h


def fused_sa_stage_plain(stage: int, dense, planes, nbr_mask, params: dict, folds: Folds = (),
                         *, act: Optional[str] = "ReLU", bf16: bool = False):
    """The plain PyTorch version of one pass: ``stage`` 1 or 2 -> (s, ss)
    (C,) float32 column sums and sums of squares of h1 (of h2) over the valid
    slots; 3 -> (out (B, M, C3) float32, argmax (B, M, C3) int32). ``folds``
    holds (sc1, sh1) for stage 2 and both pairs for stage 3."""
    h = hidden_plain(stage, dense, planes, nbr_mask, params, folds, act=act, bf16=bf16)
    valid = nbr_mask.reshape(-1, 1)
    if stage < 3:
        hm = torch.where(valid, h, 0.0)
        return hm.sum(0), (hm * h).sum(0)
    b, m, k = nbr_mask.shape
    filled = torch.where(valid, h, float("-inf")).view(b, m, k, -1)
    mx = filled.amax(dim=2)
    found = mx > float("-inf")
    am = first_argmax(filled, mx, dim=2).to(torch.int32)
    return torch.where(found, mx, 0.0), torch.where(found, am, -1)


def _packed(params: dict, folds: Folds, kp: int, c1p: int, c2p: int, c3p: int, ct, device):
    """The kernel's f32 weight block: w1 (KP, C1), b1, sc1, sh1, w2 (C1, C2), b2,
    sc2, sh2, w3 (C2, C3), b3, zero-padded, the matrices rounded to ``ct``."""
    zero = torch.zeros(1, device=device)
    f = list(folds) + [(zero, zero)] * (2 - len(folds))

    def pad(x, *size):
        out = torch.zeros(size, dtype=torch.float32, device=device)
        out[tuple(slice(0, s) for s in x.shape)] = x
        return out.reshape(-1)

    def mat(w, rows, cols):
        return pad(w.detach().to(ct).float(), rows, cols)

    def vec(v, cols):
        return pad(v.detach().float().reshape(-1), cols)

    return torch.cat([
        mat(params["w1"], kp, c1p), vec(params["b1"], c1p), vec(f[0][0], c1p),
        vec(f[0][1], c1p), mat(params["w2"], c1p, c2p), vec(params["b2"], c2p),
        vec(f[1][0], c2p), vec(f[1][1], c2p), mat(params["w3"], c2p, c3p),
        vec(params["b3"], c3p)])


def fused_sa_stage(stage: int, dense: Optional[torch.Tensor], planes: Optional[torch.Tensor],
                   nbr_mask: torch.Tensor, params: dict, folds: Folds = (), *,
                   act: Optional[str] = "ReLU", bf16: bool = False):
    """One pass of kernel 6's forward (see ``fused_sa_stage_plain``): dense
    (B, M, 64, CD) in the compute type or None, planes (B, M, 64, CP) float32 or
    None, nbr_mask (B, M, 64) bool, params {w1 (CD+CP, C1), b1, w2, b2, w3, b3}
    (the gammas and betas enter through ``folds``).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if stage not in ENTRIES:
        raise ValueError(f"stage must be 1, 2 or 3, got {stage}")
    if nbr_mask.device.type == "cpu":
        return fused_sa_stage_plain(stage, dense, planes, nbr_mask, params, folds, act=act,
                                    bf16=bf16)
    if nbr_mask.device.type != "cuda":
        raise RuntimeError(f"fused_sa_stage runs on cuda or cpu tensors, got {nbr_mask.device}")
    cd, cp = _widths(dense, planes, nbr_mask, params)
    _check_act(act)
    if len(folds) < stage - 1:
        raise ValueError(f"stage {stage} needs {stage - 1} folded BatchNorms, got {len(folds)}")
    b, m, _ = nbr_mask.shape
    dev = nbr_mask.device
    ct = torch.bfloat16 if bf16 else torch.float32
    c1, c2, c3 = (params[f"w{i}"].shape[1] for i in (1, 2, 3))
    kp = round_up(cd + cp, 4)
    c1p, c2p, c3p = (round_up(c, WIDTH_STEP) for c in (c1, c2, c3))
    w = _packed(params, folds[:stage - 1], kp, c1p, c2p, c3p, ct, dev)
    dense = None if dense is None else dense.to(ct).contiguous()
    planes = None if planes is None else planes.float().contiguous()
    nbr_mask = nbr_mask.contiguous()
    _build.check_cuda("fused_sa_stage", nbr_mask, w,
                      *(x for x in (dense, planes) if x is not None))
    partial = sums = out = amax = None
    if stage < 3:
        cw = c1p if stage == 1 else c2p
        partial = torch.empty((MAX_GRID, 2, cw), dtype=torch.float64, device=dev)
        sums = torch.empty((2, cw), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((b, m, c3), dtype=torch.float32, device=dev)
        amax = torch.empty((b, m, c3), dtype=torch.int32, device=dev)
    _build.launch(ENTRIES[stage], _ARGTYPES, _build.ptr(dense), _build.ptr(planes),
                  nbr_mask.data_ptr(), w.data_ptr(), _build.ptr(partial), _build.ptr(sums),
                  _build.ptr(out), _build.ptr(amax), b * m, cd, cp, kp, c1p, c2p, c3p, c3,
                  ACTS[act], int(bf16), MAX_GRID, _build.stream_of(nbr_mask))
    if stage < 3:
        c = c1 if stage == 1 else c2
        return sums[0, :c], sums[1, :c]
    return out, amax


def _stats(s, ss, cnt):
    mean = s / cnt
    return mean, torch.clamp_min(ss / cnt - mean * mean, 0.0)


def _fold(gamma, beta, mean, var):
    scale = gamma * torch.rsqrt(var + EPS)
    return scale, beta - mean * scale


def _needs_backward(dense, params) -> bool:
    return torch.is_grad_enabled() and (
        (dense is not None and dense.requires_grad)
        or any(torch.is_tensor(v) and v.requires_grad for v in params.values()))


def _chain(stage_fn, dense, planes, nbr_mask, params, running, act, bf16, train):
    """F1 -> F2 -> F3 (train) or F3 alone on the running statistics (eval) ->
    (out, (mean1, var1, mean2, var2), argmax)."""
    if _needs_backward(dense, params):
        raise NotImplementedError(BACKWARD_MISSING)
    if not train and running is None:
        raise ValueError("eval mode (train=False) needs the running statistics")
    cnt = torch.clamp_min(nbr_mask.sum().float(), 1.0)
    folds, stats = [], []
    for layer in (1, 2):
        if train:
            mean, var = _stats(*stage_fn(layer, dense, planes, nbr_mask, params, folds, act=act,
                                         bf16=bf16), cnt)
        else:
            mean, var = (r.float() for r in running[2 * layer - 2:2 * layer])
        folds.append(_fold(params[f"gamma{layer}"], params[f"beta{layer}"], mean, var))
        stats += [mean, var]
    out, amax = stage_fn(3, dense, planes, nbr_mask, params, folds, act=act, bf16=bf16)
    return out, tuple(stats), amax


def fused_sa_mlp_plain(dense, planes, nbr_mask, params: dict, running=None, *,
                       act: Optional[str] = "ReLU", bf16: bool = False, train: bool = True):
    """The plain version of the whole forward: (out (B, M, C3) float32, the
    statistics (mean1, var1, mean2, var2) — the batch's in train mode, the
    running ones given in eval — and the argmax (B, M, C3) int32)."""
    return _chain(fused_sa_stage_plain, dense, planes, nbr_mask, params, running, act, bf16,
                  train)


def fused_sa_mlp(dense: Optional[torch.Tensor], planes: Optional[torch.Tensor],
                 nbr_mask: torch.Tensor, params: dict, running=None, *,
                 act: Optional[str] = "ReLU", bf16: bool = False, train: bool = True,
                 return_argmax: bool = False):
    """Fused SA-layer MLP + masked max over the 64 slots, as the JAX function.

    dense (B, M, 64, CD) (invalid rows zeroed; cast to the compute type) or
    None; planes (B, M, 64, CP) float32 or None; W1's rows are [dense...,
    planes...]; params {w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, w3, b3}
    with each w (in, out). Train: (out, (mean1, var1, mean2, var2)) with the
    batch statistics for the caller's running update. Eval (``train=False``,
    ``running`` = (mean1, var1, mean2, var2)): out. ``return_argmax=True``
    (train only) returns (out, stats, argmax). Raises
    ``NotImplementedError`` where autograd would need the backward."""
    if return_argmax and not train:
        raise ValueError("return_argmax requires train=True")
    out, stats, amax = _chain(fused_sa_stage, dense, planes, nbr_mask, params, running, act,
                              bf16, train)
    if return_argmax:
        return out, stats, amax
    return (out, stats) if train else out
