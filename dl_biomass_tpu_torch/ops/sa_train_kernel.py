"""Kernel 6: the fused SA-layer MLP and masked max, forward and backward (port
of ``dl_biomass_tpu/ops/pallas_sa_train.py`` fused_sa_mlp).

An SA layer's edge MLP ``[C0, C1, C2, C3]`` (Linear, BatchNorm, act, twice,
then Linear) and its masked max over the 64 neighbour slots, computed by
three recomputing passes that keep every hidden value on chip:

  F1: h1 = [dense, planes] W1 + b1; masked column sums and sums of squares
  F2: recompute h1; a1 = act(h1 sc1 + sh1); h2 = a1 W2 + b2; the same sums of h2
  F3: recompute to h3 = a2 W3 + b3; masked max over the slots and first argmax

with the batch statistics (train) or the running ones (eval) folded into
(sc, sh) between the passes. Its backward recomputes the same chain three
times more, with the cotangent of the pooled output routed to F3's argmax
slot (a centroid with argmax -1 gets nothing):

  B1: dW3, db3, and the sums of db2n = da2 act'(z2) and of db2n xhat2
  B2: dh2 = sc2 (db2n - t2a - xhat2 t2b); dW2, db2, the same sums of layer 1
  B3: dh1 likewise; dW1 over the [dense..., planes...] rows, db1, d(dense)

with ``t2a = sum(db2n) / cnt`` and ``t2b = sum(db2n xhat2) / cnt`` between
the passes (0 in eval mode: the running statistics are constants),
dgamma = sum(db xhat) and dbeta = sum(db). The numerics are the JAX
function's: one-pass statistics ``mean = s / cnt``, ``var = max(ss / cnt -
mean^2, 0)`` with ``cnt = max(sum(nbr_mask), 1)``, eps 1e-5; in bf16 mode
each product takes bf16-rounded operands with float32 accumulation (the
weights, the edge rows, a1, a2, the routed cotangent, dh2 and dh1) while the
hidden values, the column sums and the statistics stay float32; in float32
mode plain float32 products; float64 inputs (``dense`` or ``planes``) compute
in float64 throughout, on the CPU only, with the parameters promoted as the
JAX function promotes them (the pooled output then stays float64, where the
JAX function casts it to float32). The output is 0 (argmax -1) where a
centroid has no valid slot.

``fused_sa_stage`` (one forward pass) and ``fused_sa_bwd_stage`` (one
backward pass) launch ``csrc/fused_sa_fwd.cu`` (entries ``dlbt_fused_sa_f1``,
``_f2``, ``_f3``) and ``csrc/fused_sa_bwd.cu`` (``dlbt_fused_sa_b1``, ``_b2``,
``_b3``) on a CUDA tensor and run ``fused_sa_stage_plain`` and
``fused_sa_bwd_stage_plain`` on a CPU tensor. Each entry runs one of two
hand-written kernels, which ``mma_takes`` picks from the layer's widths
before any launch (``pass_source`` names it): in bf16, where the tensor-core
kernels' weight block, buffers and register tiles fit (every layer at
neuron_multiplier 1, SA1 at 2), F1-F3 and B1-B3 run on the tensor cores
(``csrc/fused_sa_f1.cu``, ``_f2.cu``, ``_f3.cu``, ``_b1.cu``, ``_b2.cu``,
``_b3.cu``) with the bf16 weight block of ``_packed_bf16``, which ``pack_fwd``
makes once per layer's forward and ``pack_bwd`` hands on to its backward;
every f32 pass and the bf16 passes of wider layers run on the CUDA cores
(``csrc/fused_sa_fwd.cu``, ``csrc/fused_sa_bwd.cu``, whose backward keeps
the buffers that do not fit shared memory in a device scratch buffer). ``fused_sa_mlp`` chains them as
the JAX function does, inside a ``torch.autograd.Function``;
``fused_sa_mlp_plain`` chains the plain passes the same way. The kernels sum
in their own order (float32 FMAs or tensor-core
products per row, float32 per block, float64 across blocks), so they agree
with the plain versions to float32 rounding of the sums (bf16: a value near a
rounding boundary may round one step the other way).

The planes arrive as one (B, M, 64, CP) tensor (kernel 2's edges at SA1, the
centroid-relative positions at SA2) where the JAX package passes CP (B, M, 64)
planes, a TPU layout. ``dense`` gets its gradient in its own dtype; the
planes, the mask and the returned statistics get none.
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
WIDTH_STEP = 64  # the kernels' layer widths are multiples of 64 (zero-padded)
MAX_GRID = 1024  # blocks of a kernel at most: the rows of its per-block scratch
ACTS = {None: 0, "None": 0, "ReLU": 1, "LeakyReLU": 2, "ELU": 3}
ENTRIES = {1: "dlbt_fused_sa_f1", 2: "dlbt_fused_sa_f2", 3: "dlbt_fused_sa_f3"}
BWD_ENTRIES = {1: "dlbt_fused_sa_b1", 2: "dlbt_fused_sa_b2", 3: "dlbt_fused_sa_b3"}
PARAMS = ("w1", "b1", "gamma1", "beta1", "w2", "b2", "gamma2", "beta2", "w3", "b3")
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
SKEW_H = 8  # csrc/mma_bf16.cuh kSkewH: each bf16 weight row is this many values longer
SMEM_MAX = 232448  # bytes of shared memory a block may opt in to on an H100 (227 KiB)

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


def _act_deriv(z: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    _check_act(name)
    if ACTS[name] == 1:
        return (z > 0).to(z.dtype)
    if ACTS[name] == 2:
        return torch.where(z > 0, torch.ones_like(z), torch.full_like(z, 0.01))
    if ACTS[name] == 3:
        return torch.where(z > 0, 1.0, torch.exp(torch.clamp_max(z, 0.0)))
    return torch.ones_like(z)


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


def _types(dense, planes, bf16: bool):
    """(accumulation type, product operand type): float64 when dense or planes
    is float64 (bf16 is then ignored, as in the JAX function), else float32
    and bf16 or float32."""
    if any(x is not None and x.dtype == torch.float64 for x in (dense, planes)):
        return torch.float64, torch.float64
    return torch.float32, (torch.bfloat16 if bf16 else torch.float32)


def _hiddens(layers: int, dense, planes, nbr_mask, params: dict, folds: Folds, act, bf16):
    """[h1, ..., h_layers] of every edge row, each (B*M*64, C) in the
    accumulation type."""
    cd, cp = _widths(dense, planes, nbr_mask, params)
    _check_act(act)
    ft, ct = _types(dense, planes, bf16)

    def dot(x, w):
        return _dot_f32(x.reshape(-1, x.shape[-1]).to(ct), w.to(ct))

    w1 = params["w1"]
    h = dot(planes.to(ft), w1[cd:]) if cp else 0.0
    if cd:
        h = h + dot(dense, w1[:cd])
    hs = [h + params["b1"].to(ft)]
    for i in range(2, layers + 1):
        sc, sh = folds[i - 2]
        hs.append(dot(_act(hs[-1] * sc + sh, act), params[f"w{i}"]) + params[f"b{i}"].to(ft))
    return hs


def hidden_plain(layer: int, dense, planes, nbr_mask, params: dict, folds: Folds = (), *,
                 act: Optional[str] = "ReLU", bf16: bool = False) -> torch.Tensor:
    """h1, h2 or h3 (``layer`` 1, 2, 3) of every edge row, (B*M*64, C) float32
    (float64 for float64 inputs): the chain the passes recompute, with
    ``folds`` = [(sc1, sh1), (sc2, sh2)]."""
    return _hiddens(layer, dense, planes, nbr_mask, params, folds, act, bf16)[-1]


def fused_sa_stage_plain(stage: int, dense, planes, nbr_mask, params: dict, folds: Folds = (),
                         *, act: Optional[str] = "ReLU", bf16: bool = False, packed=None):
    """The plain PyTorch version of one pass: ``stage`` 1 or 2 -> (s, ss)
    (C,) column sums and sums of squares of h1 (of h2) over the valid slots,
    accumulated in float64 as the kernel's are; 3 -> (out (B, M, C3), argmax
    (B, M, C3) int32). float32, or float64 for float64 inputs. ``folds`` holds
    (sc1, sh1) for stage 2 and both pairs for stage 3; ``packed``, the
    kernels' weight block (``pack_fwd``), is not read."""
    h = hidden_plain(stage, dense, planes, nbr_mask, params, folds, act=act, bf16=bf16)
    valid = nbr_mask.reshape(-1, 1)
    if stage < 3:
        hm = torch.where(valid, h, 0.0)
        return (hm.sum(0, dtype=torch.float64).to(h.dtype),
                (hm * h).sum(0, dtype=torch.float64).to(h.dtype))
    b, m, k = nbr_mask.shape
    filled = torch.where(valid, h, float("-inf")).view(b, m, k, -1)
    mx = filled.amax(dim=2)
    found = mx > float("-inf")
    am = first_argmax(filled, mx, dim=2).to(torch.int32)
    return torch.where(found, mx, 0.0), torch.where(found, am, -1)


def _routed(g: torch.Tensor, amax: torch.Tensor, ft) -> torch.Tensor:
    """The cotangent (B, M, C3) at F3's argmax slots -> (B*M*64, C3); argmax
    -1 routes nothing."""
    b, m, c3 = g.shape
    gs = torch.zeros((b, m, K, c3), dtype=ft, device=g.device)
    src = torch.where(amax >= 0, g.to(ft), 0.0)
    gs.scatter_(2, amax.clamp_min(0).long().unsqueeze(2), src.unsqueeze(2))
    return gs.view(-1, c3)


def fused_sa_bwd_stage_plain(stage: int, dense, planes, nbr_mask, params: dict, folds: Folds,
                             stats: Folds, terms: Folds, g: torch.Tensor, amax: torch.Tensor, *,
                             act: Optional[str] = "ReLU", bf16: bool = False, packed=None):
    """The plain PyTorch version of one backward pass. ``folds`` = [(sc1, sh1),
    (sc2, sh2)], ``stats`` = [(mean1, inv1), (mean2, inv2)] with inv =
    rsqrt(var + eps), ``terms`` = [(t2a, t2b)] for stage 2 and [(t2a, t2b),
    (t1a, t1b)] for stage 3; ``g`` the cotangent of the pooled output and
    ``amax`` F3's argmax, both (B, M, C3); ``packed``, the kernels' block
    (``pack_bwd``), is not read. The column sums accumulate in
    float64, as the kernel's do (their terms cancel: SA1's db3 is 0 but for
    rounding). Returns, float32 (float64 for float64 inputs):

      1 -> (dW3 (C2, C3), db3, sum(db2n) (C2), sum(db2n xhat2) (C2))
      2 -> (dW2 (C1, C2), db2, sum(db1n) (C1), sum(db1n xhat1) (C1))
      3 -> (dW1 (CD+CP, C1), db1, d(dense) (B, M, 64, CD) in the product type
            or None)
    """
    cd, cp = _widths(dense, planes, nbr_mask, params)
    ft, ct = _types(dense, planes, bf16)

    def dot(x, w):
        return _dot_f32(x.to(ct), w.to(ct))

    def colsum(x):
        return x.sum(0, dtype=torch.float64).to(ft)

    h1, h2 = _hiddens(2, dense, planes, nbr_mask, params, folds, act, bf16)
    valid = nbr_mask.reshape(-1, 1).to(ft)
    (sc1, sh1), (sc2, sh2) = folds
    (mean1, inv1), (mean2, inv2) = stats
    z2 = h2 * sc2 + sh2
    gs = _routed(g, amax, ft)
    db2n = dot(gs, params["w3"].t()) * _act_deriv(z2, act) * valid
    xhat2 = (h2 - mean2) * inv2
    if stage == 1:
        return dot(_act(z2, act).t(), gs), colsum(gs), colsum(db2n), colsum(db2n * xhat2)
    (t2a, t2b) = terms[0]
    dh2 = sc2 * (db2n - t2a - xhat2 * t2b) * valid
    z1 = h1 * sc1 + sh1
    db1n = dot(dh2, params["w2"].t()) * _act_deriv(z1, act) * valid
    xhat1 = (h1 - mean1) * inv1
    if stage == 2:
        return dot(_act(z1, act).t(), dh2), colsum(dh2), colsum(db1n), colsum(db1n * xhat1)
    (t1a, t1b) = terms[1]
    dh1 = sc1 * (db1n - t1a - xhat1 * t1b) * valid
    parts = ([dense.reshape(-1, cd).to(ct)] if cd else []) + (
        [planes.reshape(-1, cp).to(ft).to(ct)] if cp else [])
    dw1 = dot(torch.cat(parts, dim=1).t(), dh1)
    d_dense = None
    if cd:
        d_dense = dot(dh1, params["w1"][:cd].t()).view(*nbr_mask.shape, cd).to(ct)
    return dw1, colsum(dh1), d_dense


def _pad(x: torch.Tensor, *size: int) -> torch.Tensor:
    out = torch.zeros(size, dtype=torch.float32, device=x.device)
    out[tuple(slice(0, s) for s in x.shape)] = x.detach()
    return out.reshape(-1)


def _mat(w: torch.Tensor, rows: int, cols: int, ct) -> torch.Tensor:
    """A zero-padded (rows, cols) f32 matrix, rounded to ``ct``, flattened."""
    return _pad(w.to(ct).float(), rows, cols)


def _vec(v: torch.Tensor, cols: int) -> torch.Tensor:
    return _pad(v.float().reshape(-1), cols)


def _packed(params: dict, folds: Folds, kp: int, c1p: int, c2p: int, c3p: int, ct, device):
    """The kernels' f32 weight block: w1 (KP, C1), b1, sc1, sh1, w2 (C1, C2), b2,
    sc2, sh2, w3 (C2, C3), b3, zero-padded, the matrices rounded to ``ct``."""
    zero = torch.zeros(1, device=device)
    f = list(folds) + [(zero, zero)] * (2 - len(folds))
    return torch.cat([
        _mat(params["w1"], kp, c1p, ct), _vec(params["b1"], c1p), _vec(f[0][0], c1p),
        _vec(f[0][1], c1p), _mat(params["w2"], c1p, c2p, ct), _vec(params["b2"], c2p),
        _vec(f[1][0], c2p), _vec(f[1][1], c2p), _mat(params["w3"], c2p, c3p, ct),
        _vec(params["b3"], c3p)])


def _packed_bwd(params: dict, folds: Folds, stats: Folds, terms: Folds, cd: int, kp: int,
                c1p: int, c2p: int, c3p: int, cdp: int, ct, device):
    """The forward block, then mean1, inv1 (C1), mean2, inv2 (C2), t2a, t2b
    (C2), t1a, t1b (C1) and the transposed products' weights w3^T (C3, C2),
    w2^T (C2, C1), w1's dense rows transposed (C1, CDP)."""
    zero = torch.zeros(1, device=device)
    t = list(terms) + [(zero, zero)] * (2 - len(terms))
    (mean1, inv1), (mean2, inv2) = stats
    return torch.cat([
        _packed(params, folds, kp, c1p, c2p, c3p, ct, device),
        _vec(mean1, c1p), _vec(inv1, c1p), _vec(mean2, c2p), _vec(inv2, c2p),
        _vec(t[0][0], c2p), _vec(t[0][1], c2p), _vec(t[1][0], c1p), _vec(t[1][1], c1p),
        _mat(params["w3"].t(), c3p, c2p, ct), _mat(params["w2"].t(), c2p, c1p, ct),
        _mat(params["w1"][:cd].t(), c1p, cdp, ct)])


def edge_width(cd: int, cp: int) -> int:
    """KX, the edge rows' width in the bf16 passes: the dense channels, then the
    planes from CD rounded up to 16, zero-padded to a multiple of 16."""
    return round_up(cd, 16) + round_up(cp, 16)


def _packed_bf16(params: dict, cd: int, cp: int, c1p: int, c2p: int, c3p: int, device):
    """The bf16 passes' weight block, flat bf16, laid out as their kernels hold
    it in shared memory: W1^T (C1, KX) with the dense rows' columns at 0 and
    the planes' at CD rounded up to 16 (``edge_width``), W2^T (C2, C1) and W3
    (C2, C3), each zero-padded and each row ``SKEW_H`` zeros longer."""
    cd16 = round_up(cd, 16)
    w1, w2, w3 = (params[k].detach() for k in ("w1", "w2", "w3"))
    c1, c2, c3 = w1.shape[1], w2.shape[1], w3.shape[1]
    w1t = torch.zeros((c1p, edge_width(cd, cp) + SKEW_H), dtype=torch.bfloat16, device=device)
    w1t[:c1, :cd] = w1[:cd].t()
    w1t[:c1, cd16:cd16 + cp] = w1[cd:].t()
    w2t = torch.zeros((c2p, c1p + SKEW_H), dtype=torch.bfloat16, device=device)
    w2t[:c2, :c1] = w2.t()
    w3p = torch.zeros((c2p, c3p + SKEW_H), dtype=torch.bfloat16, device=device)
    w3p[:c2, :c3] = w3
    return torch.cat([w1t.reshape(-1), w2t.reshape(-1), w3p.reshape(-1)])


VECS = 7  # per-column vectors of a layer in the bf16 passes: b, sc, sh, mean, inv, ta, tb
TA = 5  # the row of ta among them (tb follows)


def _vectors(params: dict, folds: Folds, stats: Folds, c1p: int, c2p: int):
    """The bf16 passes' f32 per-column vectors, as their kernels hold them in
    shared memory: b1, sc1, sh1, mean1, inv1, t1a, t1b (C1 each), then b2, sc2,
    sh2, mean2, inv2, t2a, t2b (C2 each), zero-padded; the correction terms 0
    (``_with_terms`` adds them)."""
    (sc1, sh1), (sc2, sh2) = folds
    (mean1, inv1), (mean2, inv2) = stats
    layers = (([params["b1"], sc1, sh1, mean1, inv1], c1p),
              ([params["b2"], sc2, sh2, mean2, inv2], c2p))
    rows = []
    for vs, c in layers:
        v = torch.stack(vs).detach().float()
        rows.append(torch.nn.functional.pad(v, (0, c - v.shape[1], 0, VECS - v.shape[0]))
                    .reshape(-1))
    return torch.cat(rows)


def _with_terms(vectors: torch.Tensor, terms: Folds, c1p: int, c2p: int) -> torch.Tensor:
    """``vectors`` with the correction terms given so far, [(t2a, t2b)] then
    (t1a, t1b), in their rows (a new tensor; ``vectors`` unchanged when there
    are any)."""
    if not terms:
        return vectors
    out = vectors.clone()
    layers = (out[VECS * c1p:].view(VECS, c2p), out[:VECS * c1p].view(VECS, c1p))
    for rows, (ta, tb) in zip(layers, terms):
        rows[TA, :ta.shape[0]] = ta.detach()
        rows[TA + 1, :tb.shape[0]] = tb.detach()
    return out


def _padded_widths(params: dict):
    return tuple(round_up(params[f"w{i}"].shape[1], WIDTH_STEP) for i in (1, 2, 3))


def _mma_smem(cd: int, cp: int, c1: int, c2: int, c3: int) -> dict:
    """The shared memory, in bytes, of each tensor-core pass at these padded
    widths, as the ``Layout`` of its kernel (``csrc/fused_sa_b1.cu``,
    ``_b2.cu``, ``_b3.cu``, ``_f1.cu``, ``_f2.cu``, ``_f3.cu``) lays it out,
    each region rounded up to 16 bytes."""
    kx = edge_width(cd, cp)
    x = 2 * K * (kx + SKEW_H)

    def inputs(c):  # fused_sa_mma.cuh Inputs: edge rows, mask, cotangent, argmax, planes
        return sum(round_up(n, 16) for n in (x, K, 4 * c, 4 * c, 4 * K * cp))

    def w(rows, cols):  # a bf16 weight matrix, each row SKEW_H longer
        return 2 * rows * (cols + SKEW_H)

    w12, vec = w(c1, kx) + w(c2, c1), 4 * VECS * (c1 + c2)
    a1, a2 = 2 * K * (c1 + SKEW_H), 2 * K * (c2 + SKEW_H)
    n3 = min(c3, 256)  # B1's column group
    red_b1, red_b2 = 4 * 4 * 2 * c2, 4 * 4 * (c2 + 2 * c1)
    return {
        "b1": sum(round_up(n, 16) for n in (w12 + w(c2, n3), vec, 2 * inputs(c3), 2 * n3, 2 * n3,
                                             a1, a2, 0 if red_b1 <= x else red_b1)),
        "b2": sum(round_up(n, 16) for n in (w12 + w(c2, c3), vec, 2 * inputs(c3), 2 * c3, 2 * c3,
                                             a1, a2, 0 if red_b2 <= x else red_b2)),
        "b3": sum(round_up(n, 16) for n in (w12 + w(c2, c3), vec, 2 * inputs(c3), 2 * c3, 2 * c3,
                                             a1, a2, 4 * 4 * c1, 8 * c1)),
        "f1": sum(round_up(n, 16) for n in (w(c1, kx), 4 * c1, 2 * inputs(0), 4 * 4 * 2 * c1)),
        "f2": sum(round_up(n, 16) for n in (w12, vec, 2 * inputs(0), a1,
                                             0 if 4 * 4 * 2 * c2 <= x else 4 * 4 * 2 * c2)),
        "f3": sum(round_up(n, 16) for n in (w12 + w(c2, c3), vec + 4 * c3, 2 * inputs(0), a1,
                                             0 if c2 <= kx else a2, 8 * 4 * c3)),
    }


def mma_takes(cd: int, cp: int, c1p: int, c2p: int, c3p: int) -> bool:
    """Whether a layer of these widths (CD dense and CP plane channels, the
    hidden widths padded to 64) runs its bf16 passes F1-F3 and B1-B3 on the
    tensor cores: each kernel's own checks pass (C1 64 or 128; B1's dW3 tiles
    and vector slice, so C2 at most 128; B2's dW2 tiles and slice; B3's dW1
    tiles; F2's slice; F1's block is a part of F2's) and its weight block and
    buffers fit a block's shared memory. Where not, those passes run on the
    CUDA-core kernels, in bf16 all the same. Decided from the widths alone,
    before any launch."""
    if c1p not in (64, 128) or c2p % 64 or c3p % 64:
        return False
    kx, n3 = edge_width(cd, cp), min(c3p, 256)
    fits = ((n3 // 16) * (c2p // 16) <= 8 * 16 and n3 + 2 * c2p <= 512  # B1
            and (c1p // 16) * (c2p // 16) <= 8 * 8 and c2p + 2 * c1p <= 512  # B2
            and (kx // 16) * (c1p // 16) <= 8 * 9  # B3
            and 2 * c2p <= 512)  # F2
    return fits and max(_mma_smem(cd, cp, c1p, c2p, c3p).values()) <= SMEM_MAX


def _on_tensor_cores(cd: int, cp: int, params: dict, bf16: bool) -> bool:
    return bf16 and mma_takes(cd, cp, *_padded_widths(params))


def pass_source(stage: int, backward: bool, cd: int, cp: int, params: dict, bf16: bool) -> str:
    """The CUDA source whose kernel runs this pass on a card (the routing of
    ``fused_sa_stage`` and ``fused_sa_bwd_stage``)."""
    if _on_tensor_cores(cd, cp, params, bf16):
        return f"csrc/fused_sa_{'b' if backward else 'f'}{stage}.cu"
    return f"csrc/fused_sa_{'bwd' if backward else 'fwd'}.cu"


def _vectors_fwd(params: dict, folds: Folds, c1p: int, c2p: int, c3p: int) -> torch.Tensor:
    """The tensor-core forward passes' f32 vectors: ``_vectors`` of the folds
    given so far (the missing ones, the statistics and the terms 0), then b3
    zero-padded to C3."""
    zeros = [(torch.zeros_like(params[f"b{i}"]),) * 2 for i in (1, 2)]
    f = list(folds) + zeros[len(folds):]
    return torch.cat([_vectors(params, f, zeros, c1p, c2p), _vec(params["b3"], c3p)])


def _weight_block(params: dict, cd: int, cp: int):
    """The bf16 weight block of the tensor-core passes, or None where
    ``mma_takes`` sends the layer to the CUDA cores."""
    c1p, c2p, c3p = _padded_widths(params)
    if not mma_takes(cd, cp, c1p, c2p, c3p):
        return None
    return _packed_bf16(params, cd, cp, c1p, c2p, c3p, params["w1"].device)


def pack_fwd(dense, planes, nbr_mask, params: dict):
    """The bf16 weight block that one layer's bf16 forward passes share on
    the tensor cores (``_packed_bf16``; F1 reads its W1^T, F2 W1^T and W2^T,
    F3 all of it), or None where ``mma_takes`` sends the layer to the CUDA
    cores. Its backward reuses it (``pack_bwd``)."""
    cd, cp = _widths(dense, planes, nbr_mask, params)
    return _weight_block(params, cd, cp)


def pack_bwd(dense, planes, nbr_mask, params: dict, folds: Folds, stats: Folds, wb=None):
    """The block the three bf16 backward passes of one layer share on the
    tensor cores: (the bf16 weight block of ``_packed_bf16``, or ``wb``, the
    forward's ``pack_fwd`` of the same parameters; the vectors of ``_vectors``
    with their correction terms 0), or None where ``mma_takes`` sends the
    layer to the CUDA cores. ``fused_sa_bwd_stage(..., bf16=True,
    packed=...)`` takes it and adds the terms; without it a tensor-core pass
    packs for itself."""
    cd, cp = _widths(dense, planes, nbr_mask, params)
    c1p, c2p, c3p = _padded_widths(params)
    if wb is None:
        wb = _weight_block(params, cd, cp)
    return None if wb is None else (wb, _vectors(params, folds, stats, c1p, c2p))


def _check_block(x: torch.Tensor, dt, n: int, device) -> None:
    if x.dtype != dt or x.numel() != n or x.device != device or not x.is_contiguous():
        raise ValueError(f"fused SA kernel: the packed block holds {x.numel()} {x.dtype} on "
                         f"{x.device}; this call's widths need {n} contiguous {dt} on {device}")


def _weight_block_size(kx: int, c1p: int, c2p: int, c3p: int) -> int:
    return c1p * (kx + SKEW_H) + c2p * (c1p + SKEW_H) + c2p * (c3p + SKEW_H)


def _check_packed(packed, kx: int, c1p: int, c2p: int, c3p: int, device):
    """Refuse a ``pack_bwd`` block made for other widths or another device:
    the kernels copy as many bytes as this call's widths give."""
    wb, w = packed
    _check_block(wb, torch.bfloat16, _weight_block_size(kx, c1p, c2p, c3p), device)
    _check_block(w, torch.float32, VECS * (c1p + c2p), device)


def _on_card(name: str, dense, planes, nbr_mask):
    """Refuse what the kernels do not take: float64 (never cast down) and any
    device but a card."""
    if any(x is not None and x.dtype == torch.float64 for x in (dense, planes)):
        raise ValueError(f"{name}: the kernel computes in float32 or bf16; float64 runs on "
                         "CPU tensors only")
    if nbr_mask.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu tensors, got {nbr_mask.device}")


def fused_sa_stage(stage: int, dense: Optional[torch.Tensor], planes: Optional[torch.Tensor],
                   nbr_mask: torch.Tensor, params: dict, folds: Folds = (), *,
                   act: Optional[str] = "ReLU", bf16: bool = False, packed=None):
    """One pass of kernel 6's forward (see ``fused_sa_stage_plain``): dense
    (B, M, 64, CD) in the compute type or None, planes (B, M, 64, CP) float32 or
    None, nbr_mask (B, M, 64) bool, params {w1 (CD+CP, C1), b1, w2, b2, w3, b3}
    (the gammas and betas enter through ``folds``). ``packed``: this layer's
    ``pack_fwd`` block (F1-F3 on the tensor cores read it, the CUDA-core
    passes none), made here for a tensor-core pass when not given; an f32
    pass, a block for a pass on the CUDA cores, or one of other widths or on
    another device, raises ``ValueError``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    that ``pass_source`` names (float64 raises ``ValueError`` there)."""
    if stage not in ENTRIES:
        raise ValueError(f"stage must be 1, 2 or 3, got {stage}")
    if packed is not None and not bf16:
        raise ValueError("fused_sa_stage: the bf16 passes' packed block reached an f32 pass")
    if nbr_mask.device.type == "cpu":
        return fused_sa_stage_plain(stage, dense, planes, nbr_mask, params, folds, act=act,
                                    bf16=bf16)
    _on_card("fused_sa_stage", dense, planes, nbr_mask)
    cd, cp = _widths(dense, planes, nbr_mask, params)
    _check_act(act)
    if len(folds) < stage - 1:
        raise ValueError(f"stage {stage} needs {stage - 1} folded BatchNorms, got {len(folds)}")
    b, m, _ = nbr_mask.shape
    dev = nbr_mask.device
    ct = torch.bfloat16 if bf16 else torch.float32
    c1, c2, c3 = (params[f"w{i}"].shape[1] for i in (1, 2, 3))
    kp = round_up(cd + cp, 4)
    c1p, c2p, c3p = _padded_widths(params)
    wb = None
    if _on_tensor_cores(cd, cp, params, bf16):
        wb = _weight_block(params, cd, cp) if packed is None else packed
        _check_block(wb, torch.bfloat16, _weight_block_size(edge_width(cd, cp), c1p, c2p, c3p),
                     dev)
        w = _vectors_fwd(params, folds[:stage - 1], c1p, c2p, c3p)
    elif packed is not None:
        raise ValueError(f"fused_sa_stage: a tensor-core block reached pass F{stage}, which "
                         f"runs on the CUDA cores at widths {(c1, c2, c3)}")
    else:
        w = _packed(params, folds[:stage - 1], kp, c1p, c2p, c3p, ct, dev)
    dense = None if dense is None else dense.to(ct).contiguous()
    planes = None if planes is None else planes.float().contiguous()
    nbr_mask = _build.aligned16(nbr_mask.contiguous())
    _build.check_cuda("fused_sa_stage", nbr_mask, w,
                      *(x for x in (dense, planes, wb) if x is not None))
    partial = sums = out = amax = None
    if stage < 3:
        cw = c1p if stage == 1 else c2p
        partial = torch.empty((MAX_GRID, 2, cw), dtype=torch.float64, device=dev)
        sums = torch.empty((2, cw), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((b, m, c3), dtype=torch.float32, device=dev)
        amax = torch.empty((b, m, c3), dtype=torch.int32, device=dev)
    _build.launch(ENTRIES[stage], _ARGTYPES, _build.ptr(dense), _build.ptr(planes),
                  nbr_mask.data_ptr(), w.data_ptr(), _build.ptr(wb), _build.ptr(partial),
                  _build.ptr(sums), _build.ptr(out), _build.ptr(amax), b * m, cd, cp, kp, c1p,
                  c2p, c3p, c3, ACTS[act], int(bf16), MAX_GRID, _build.stream_of(nbr_mask))
    if stage < 3:
        c = c1 if stage == 1 else c2
        return sums[0, :c], sums[1, :c]
    return out, amax


def _bwd_sizes(stage: int, kp: int, c1p: int, c2p: int, c3p: int):
    """The parts of a backward pass's output vector, as the kernel lays them out."""
    return {1: [c2p * c3p, c3p, c2p, c2p], 2: [c1p * c2p, c2p, c1p, c1p],
            3: [kp * c1p, c1p]}[stage]


def _bwd_slice_bytes(stage: int, kp: int, c1p: int, c2p: int, c3p: int) -> int:
    """Bytes of one block's scratch slice that the CUDA-core backward pass
    needs at these widths on the current card (0: its buffers fit shared
    memory): ``dlbt_fused_sa_bwd_slice_bytes``, a host function."""
    fn = _build.library().dlbt_fused_sa_bwd_slice_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    n = fn(stage, kp, c1p, c2p, c3p)
    if n < 0:
        raise RuntimeError("dlbt_fused_sa_bwd_slice_bytes: the card could not be queried")
    return n


def fused_sa_bwd_stage(stage: int, dense: Optional[torch.Tensor], planes: Optional[torch.Tensor],
                       nbr_mask: torch.Tensor, params: dict, folds: Folds, stats: Folds,
                       terms: Folds, g: torch.Tensor, amax: torch.Tensor, *,
                       act: Optional[str] = "ReLU", bf16: bool = False, packed=None):
    """One pass of kernel 6's backward (see ``fused_sa_bwd_stage_plain``; the
    inputs as ``fused_sa_stage`` takes them, and ``g``, ``amax`` (B, M, C3)).
    ``packed``: the tensor-core passes' block of this layer (``pack_bwd`` of
    the same parameters, folds and statistics), made here when not given; an
    f32 pass, a pass that runs on the CUDA cores, or a block of other widths
    or on another device, raises ``ValueError``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    that ``pass_source`` names (float64 raises ``ValueError`` there): in bf16
    the tensor-core kernel where ``mma_takes`` the layer's widths, else, as in
    f32, the CUDA-core kernel, which keeps the buffers that do not fit shared
    memory in a scratch buffer on the card."""
    if stage not in BWD_ENTRIES:
        raise ValueError(f"stage must be 1, 2 or 3, got {stage}")
    if packed is not None and not bf16:
        raise ValueError("fused_sa_bwd_stage: the bf16 passes' packed block reached an f32 pass")
    if nbr_mask.device.type == "cpu":
        return fused_sa_bwd_stage_plain(stage, dense, planes, nbr_mask, params, folds, stats,
                                        terms, g, amax, act=act, bf16=bf16)
    _on_card("fused_sa_bwd_stage", dense, planes, nbr_mask)
    cd, cp = _widths(dense, planes, nbr_mask, params)
    _check_act(act)
    if len(folds) != 2 or len(stats) != 2 or len(terms) < stage - 1:
        raise ValueError(f"backward stage {stage} needs 2 folds, 2 statistics and "
                         f"{stage - 1} correction terms")
    b, m, _ = nbr_mask.shape
    dev = nbr_mask.device
    ct = torch.bfloat16 if bf16 else torch.float32
    c1, c2, c3 = (params[f"w{i}"].shape[1] for i in (1, 2, 3))
    if tuple(g.shape) != (b, m, c3) or tuple(amax.shape) != (b, m, c3):
        raise ValueError(f"g and amax must be (B, M, C3) = {(b, m, c3)}, got "
                         f"{tuple(g.shape)} and {tuple(amax.shape)}")
    kp = round_up(cd + cp, 4)
    c1p, c2p, c3p = _padded_widths(params)
    cdp = round_up(cd, WIDTH_STEP)
    wb = scratch = None
    max_grid = MAX_GRID
    if _on_tensor_cores(cd, cp, params, bf16):
        # the tensor-core kernels: the bf16 weights, the vectors with this pass's terms
        if packed is None:
            packed = pack_bwd(dense, planes, nbr_mask, params, folds, stats)
        _check_packed(packed, edge_width(cd, cp), c1p, c2p, c3p, dev)
        wb, w = packed[0], _with_terms(packed[1], terms[:stage - 1], c1p, c2p)
    elif packed is not None:
        raise ValueError(f"fused_sa_bwd_stage: a tensor-core block reached pass B{stage}, which "
                         f"runs on the CUDA cores at widths {(c1, c2, c3)}")
    else:
        w = _packed_bwd(params, folds, stats, terms[:stage - 1], cd, kp, c1p, c2p, c3p, cdp, ct,
                        dev)
        slice_bytes = _bwd_slice_bytes(stage, kp, c1p, c2p, c3p)
        if slice_bytes:  # one slice per block, at most one block per SM
            max_grid = min(MAX_GRID, torch.cuda.get_device_properties(dev).multi_processor_count)
            scratch = torch.empty(max_grid * slice_bytes, dtype=torch.uint8, device=dev)
    dense = None if dense is None else dense.to(ct).contiguous()
    planes = None if planes is None else planes.float().contiguous()
    nbr_mask = _build.aligned16(nbr_mask.contiguous())
    g = g.float().contiguous()
    amax = amax.to(torch.int32).contiguous()
    _build.check_cuda("fused_sa_bwd_stage", nbr_mask, w, g, amax,
                      *(x for x in (dense, planes, wb, scratch) if x is not None))
    sizes = _bwd_sizes(stage, kp, c1p, c2p, c3p)
    # the blocks' partial sums: the weight gradient in f32, the rest in f64
    partial = torch.empty((max_grid, sizes[0]), dtype=torch.float32, device=dev)
    partial_v = torch.empty((max_grid, sum(sizes[1:])), dtype=torch.float64, device=dev)
    sums = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    d_dense = None
    if stage == 3 and cd:
        d_dense = torch.empty((b, m, K, cd), dtype=ct, device=dev)
    _build.launch(BWD_ENTRIES[stage], _BWD_ARGTYPES, _build.ptr(dense), _build.ptr(planes),
                  nbr_mask.data_ptr(), w.data_ptr(), _build.ptr(wb), g.data_ptr(),
                  amax.data_ptr(), partial.data_ptr(), partial_v.data_ptr(), sums.data_ptr(),
                  _build.ptr(d_dense), _build.ptr(scratch), b * m, cd, cp, kp, cdp, c1p, c2p,
                  c3p, c3, ACTS[act], int(bf16), max_grid, _build.stream_of(nbr_mask))
    parts = sums.split(sizes)
    if stage == 1:
        return parts[0].view(c2p, c3p)[:c2, :c3], parts[1][:c3], parts[2][:c2], parts[3][:c2]
    if stage == 2:
        return parts[0].view(c1p, c2p)[:c1, :c2], parts[1][:c2], parts[2][:c1], parts[3][:c1]
    return parts[0].view(kp, c1p)[:cd + cp, :c1], parts[1][:c1], d_dense


def _stats(s, ss, cnt):
    mean = s / cnt
    return mean, torch.clamp_min(ss / cnt - mean * mean, 0.0)


def _fold(gamma, beta, mean, var):
    scale = gamma * torch.rsqrt(var + EPS)
    return scale, beta - mean * scale


def _forward(stage_fn, dense, planes, nbr_mask, params, running, act, bf16, train, pack=False):
    """F1 -> F2 -> F3 (train) or F3 alone on the running statistics (eval) ->
    (out, [mean1, var1, mean2, var2], argmax, what the backward needs:
    (folds, [(mean1, inv1), (mean2, inv2)], cnt, the weight block)); with
    ``pack`` (the kernels' passes in bf16 on the card) the passes share one
    ``pack_fwd`` block, which the backward reuses."""
    if not train and running is None:
        raise ValueError("eval mode (train=False) needs the running statistics")
    ft, _ = _types(dense, planes, bf16)
    if ft == torch.float64:
        params = {k: v.to(ft) for k, v in params.items()}
    wb = pack_fwd(dense, planes, nbr_mask, params) if pack else None
    kw = dict(act=act, bf16=bf16, packed=wb)
    cnt = torch.clamp_min(nbr_mask.sum().to(ft), 1.0)
    folds, stats, norms = [], [], []
    for layer in (1, 2):
        if train:
            mean, var = _stats(*stage_fn(layer, dense, planes, nbr_mask, params, folds, **kw),
                               cnt)
        else:
            mean, var = (r.to(ft) for r in running[2 * layer - 2:2 * layer])
        folds.append(_fold(params[f"gamma{layer}"], params[f"beta{layer}"], mean, var))
        norms.append((mean, torch.rsqrt(var + EPS)))
        stats += [mean, var]
    out, amax = stage_fn(3, dense, planes, nbr_mask, params, folds, **kw)
    return out, stats, amax, (folds, norms, cnt, wb)


def _backward(stage_fn, dense, planes, nbr_mask, params, state, g, amax, act, bf16, train,
              pack=False):
    """B1 -> B2 -> B3 with the correction terms between them -> (d(dense) or
    None, {parameter name: gradient}); with ``pack`` (the kernels' passes in
    bf16 on the card) the three passes share one ``pack_bwd`` block, on the
    forward's weight block where it made one."""
    folds, norms, cnt, wb = state
    kw = dict(act=act, bf16=bf16)
    if pack:
        kw["packed"] = pack_bwd(dense, planes, nbr_mask, params, folds, norms, wb)
    args = (dense, planes, nbr_mask, params, folds, norms)
    dw3, db3, sdb2, sdb2x = stage_fn(1, *args, [], g, amax, **kw)
    terms = [(sdb2 / cnt, sdb2x / cnt) if train else
             (torch.zeros_like(sdb2), torch.zeros_like(sdb2x))]
    dw2, db2, sdb1, sdb1x = stage_fn(2, *args, terms, g, amax, **kw)
    terms.append((sdb1 / cnt, sdb1x / cnt) if train else
                  (torch.zeros_like(sdb1), torch.zeros_like(sdb1x)))
    dw1, db1, d_dense = stage_fn(3, *args, terms, g, amax, **kw)
    return d_dense, dict(w1=dw1, b1=db1, gamma1=sdb1x, beta1=sdb1, w2=dw2, b2=db2,
                         gamma2=sdb2x, beta2=sdb2, w3=dw3, b3=db3)


def _packs(plain: bool, bf16: bool, nbr_mask: torch.Tensor) -> bool:
    """Whether a layer's passes share packed blocks: the kernels' in bf16."""
    return bf16 and not plain and nbr_mask.is_cuda


class _FusedSAMLP(torch.autograd.Function):
    """The forward passes, and the backward passes as the gradient. The
    statistics and the argmax are outputs without a gradient; the forward
    keeps the inputs, the argmax and the folded statistics, no hidden value."""

    @staticmethod
    def forward(ctx, plain, dense, planes, nbr_mask, running, act, bf16, train, *values):
        params = dict(zip(PARAMS, values))
        stage_fn = fused_sa_stage_plain if plain else fused_sa_stage
        out, stats, amax, state = _forward(stage_fn, dense, planes, nbr_mask, params, running,
                                           act, bf16, train, pack=_packs(plain, bf16, nbr_mask))
        if not train:  # the running statistics, as new tensors
            stats = [s.clone() for s in stats]
        ctx.save_for_backward(dense, planes, nbr_mask, amax, *values)
        ctx.state = state
        ctx.config = (plain, act, bf16, train)
        ctx.mark_non_differentiable(amax, *stats)
        return (out, amax, *stats)

    @staticmethod
    def backward(ctx, g_out, *_):
        dense, planes, nbr_mask, amax, *values = ctx.saved_tensors
        plain, act, bf16, train = ctx.config
        ft, _ = _types(dense, planes, bf16)
        params = {k: v.to(ft) for k, v in zip(PARAMS, values)}
        stage_fn = fused_sa_bwd_stage_plain if plain else fused_sa_bwd_stage
        d_dense, grads = _backward(stage_fn, dense, planes, nbr_mask, params, ctx.state, g_out,
                                   amax, act, bf16, train, pack=_packs(plain, bf16, nbr_mask))
        need = ctx.needs_input_grad
        d_dense = d_dense.to(dense.dtype) if need[1] and d_dense is not None else None
        return (None, d_dense, None, None, None, None, None, None,
                *(grads[k].to(v.dtype) if need[8 + i] else None
                  for i, (k, v) in enumerate(zip(PARAMS, values))))


def _mlp(plain, dense, planes, nbr_mask, params, running, act, bf16, train, return_argmax):
    if return_argmax and not train:
        raise ValueError("return_argmax requires train=True")
    missing = [k for k in PARAMS if k not in params]
    if missing:
        raise ValueError(f"fused SA MLP: params lack {missing}")
    if return_argmax:  # introspection: no gradient, as in the JAX function
        with torch.no_grad():
            out, stats, amax, _ = _forward(fused_sa_stage_plain if plain else fused_sa_stage,
                                           dense, planes, nbr_mask, params, running, act, bf16,
                                           train, pack=_packs(plain, bf16, nbr_mask))
        return out, tuple(stats), amax
    out, amax, *stats = _FusedSAMLP.apply(plain, dense, planes, nbr_mask, running, act, bf16,
                                          train, *(params[k] for k in PARAMS))
    return out, tuple(stats), amax


def fused_sa_mlp_plain(dense, planes, nbr_mask, params: dict, running=None, *,
                       act: Optional[str] = "ReLU", bf16: bool = False, train: bool = True):
    """The plain version of the whole layer: (out (B, M, C3), the statistics
    (mean1, var1, mean2, var2) — the batch's in train mode, the running ones
    given in eval — and the argmax (B, M, C3) int32), differentiable through
    the plain backward passes."""
    return _mlp(True, dense, planes, nbr_mask, params, running, act, bf16, train, False)


def fused_sa_mlp(dense: Optional[torch.Tensor], planes: Optional[torch.Tensor],
                 nbr_mask: torch.Tensor, params: dict, running=None, *,
                 act: Optional[str] = "ReLU", bf16: bool = False, train: bool = True,
                 return_argmax: bool = False):
    """Fused SA-layer MLP + masked max over the 64 slots, as the JAX function.

    dense (B, M, 64, CD) (invalid rows zeroed; cast to the compute type) or
    None; planes (B, M, 64, CP) or None; W1's rows are [dense..., planes...];
    params {w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, w3, b3} with each w
    (in, out). Train: (out, (mean1, var1, mean2, var2)) with the batch
    statistics for the caller's running update. Eval (``train=False``,
    ``running`` = (mean1, var1, mean2, var2)): out. Differentiable in
    ``dense`` and every parameter (kernel 6's backward; the eval backward
    takes the running statistics as constants). ``return_argmax=True``
    (train only) returns (out, stats, argmax) without a gradient."""
    out, stats, amax = _mlp(False, dense, planes, nbr_mask, params, running, act, bf16, train,
                            return_argmax)
    if return_argmax:
        return out, stats, amax
    return (out, stats) if train else out
