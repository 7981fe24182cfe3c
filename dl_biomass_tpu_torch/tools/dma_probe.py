"""Block-copy kernel against one elementwise PyTorch call: a device-memory
bandwidth probe (port of the JAX package's ``tools/dma_probe.py``).

Times ``a + 1.0`` over 256 MB, then kernel 10 (``csrc/block_copy.cu``: o =
x + 1 over the whole tensor as 16-byte vectors, one CUDA block per chunk of
256 of them) over 128 blocks of 256 KB, 1 MB and 4 MB, the sizes at which
the TPU tool timed its Pallas block copy, and ends with a verdict line:

  BLOCK_COPY_CAP: {"torch_gbps": ..., "kernel_gbps": ..., "capped": true/false}

where ``capped`` says the kernel's best rate is below half of PyTorch's.

    python -m dl_biomass_tpu_torch.tools.dma_probe
"""

from __future__ import annotations

import ctypes
import json
from typing import Optional

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.tools._timing import best_chain_s

WINDOWS = 5  # timed chains, best taken
CHAIN = 16  # dependent calls per chain, one synchronisation each
TORCH_MB = 256
BLOCK_KBS = (256, 1024, 4096)
BLOCKS = 128
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def block_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def block_copy(x: torch.Tensor) -> torch.Tensor:
    """x (blocks, rows, 128) float32 -> x + 1.

    A CPU tensor takes the plain version; a CUDA tensor launches kernel 10
    (``dlbt_block_copy``) over the whole tensor, one CUDA block per chunk of
    256 16-byte vectors."""
    if x.device.type == "cpu":
        return block_copy_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"block_copy runs on cuda or cpu tensors, got {x.device}")
    if x.dim() != 3 or x.shape[2] != 128 or x.dtype != torch.float32:
        raise ValueError(f"x must be (blocks, rows, 128) float32, got {tuple(x.shape)} {x.dtype}")
    x = _build.aligned16(x.contiguous())
    _build.check_cuda("block_copy", x)
    out = torch.empty_like(x)
    _build.launch("dlbt_block_copy", _ARGTYPES, x.data_ptr(), out.data_ptr(), x.shape[0],
                  x.shape[1], _build.stream_of(x))
    return out


def _chained_s(fn, x: torch.Tensor) -> float:
    state = [x]

    def step():
        state[0] = fn(state[0])

    return best_chain_s(step, x.device, CHAIN, WINDOWS)


def torch_bandwidth(mb: Optional[int] = None, device=None) -> float:
    """GB/s (read + write) of ``a + 1.0`` over ``mb`` MB (``TORCH_MB``) of float32."""
    dev = resolve_device(device)
    mb = TORCH_MB if mb is None else mb
    n = mb * 2**20 // 4
    x = torch.arange(n, dtype=torch.float32, device=dev).reshape(-1, 1024)
    dt = _chained_s(lambda a: a + 1.0, x)
    gbps = 2 * n * 4 / dt / 1e9
    print(f"torch add over {mb} MB: {dt * 1e3:.3f} ms/iter -> {gbps:.1f} GB/s", flush=True)
    return gbps


def kernel_bandwidth(block_kb: int = 1024, blocks: Optional[int] = None, device=None) -> float:
    """GB/s (read + write) of kernel 10 over ``blocks`` (``BLOCKS``) blocks of
    ``block_kb`` KB."""
    dev = resolve_device(device)
    blocks = BLOCKS if blocks is None else blocks
    rows = block_kb * 1024 // (4 * 128)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(blocks, rows, 128))
                         .astype(np.float32)).to(dev)
    dt = _chained_s(block_copy, x)
    gbps = 2 * x.numel() * 4 / dt / 1e9
    print(f"kernel block copy {blocks} x {block_kb} KB blocks: {dt * 1e3:.3f} ms/iter -> "
          f"{gbps:.1f} GB/s", flush=True)
    return gbps


def main(device=None) -> dict:
    """The probe; returns the verdict it prints last."""
    dev = resolve_device(device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}",
          flush=True)
    ref = torch_bandwidth(device=dev)
    best = max(kernel_bandwidth(block_kb=kb, device=dev) for kb in BLOCK_KBS)
    verdict = dict(torch_gbps=round(ref, 1), kernel_gbps=round(best, 1), capped=best < 0.5 * ref)
    print("BLOCK_COPY_CAP: " + json.dumps(verdict), flush=True)
    return verdict


if __name__ == "__main__":
    main()
