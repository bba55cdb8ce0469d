"""The dot product of a block's selected rows with the phenotype weights: a
CUDA kernel (csrc/dot_rows.cu) and its plain version.

`dot_rows(vals, keep, y, mode, hap)` returns, for each kept line k, the
sum over the haplotypes h of vals[keep[k], h] * w(k, h), in float32:

  "diploid"  w = y[h >> 1] (a sample's two slots)
  "haploid"  w = y[h] (a uniformly haploid block, n_samples wide)
  "mixed"    y[h >> 1], and on the lines whose flag `hap` is set (a mixed
             block's haploid lines, slot-duplicated) y[h >> 1] at even h
             and 0 at odd h

It is the port's counterpart of the JAX package's jitted
`v.astype(jnp.float32) @ y2` (xsqueezeit_tpu/bench/tools.py:171).  The
wrapper launches the kernel for CUDA tensors and calls the plain version
for CPU tensors; there is no fallback from one to the other.  ``launches``
counts its calls that launch; the benchmark's launch check reads only
``pbwt_kernels.launches`` and ``wah_kernels.launches``.
"""
from __future__ import annotations

import torch

from . import _build
from ..utils import trace

#: Kernel calls since the last reset (one a call with K > 0: the partial
#: sums, then their sum where the row spans more than one tile).
launches = {"dot_rows": 0}

DOT_MODES = ("diploid", "haploid", "mixed")
#: Columns a warp sums into one partial (csrc/dot_rows.cu TILE).
TILE = 1024


def tiles(H: int) -> int:
    """Partial sums a row takes in the kernel: ceil(H / TILE)."""
    return -(-H // TILE)


def samples_needed(H: int, mode: str) -> int:
    """The least length of y the mode reads at width H."""
    return H if mode == "haploid" else (H + 1) // 2


def load_width(vals: torch.Tensor) -> int:
    """Bytes a lane of the kernel loads at once from the plane vals: 16
    where its width is a multiple of 16 and it starts on a 16-byte
    boundary (csrc/dot_rows.cu, `vec`), else 1 (byte by byte)."""
    return 16 if vals.shape[1] % 16 == 0 and vals.data_ptr() % 16 == 0 else 1


def dot_rows_plain(vals: torch.Tensor, keep: torch.Tensor, y: torch.Tensor,
                   mode: str, hap: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """vals: uint8[L, H]; keep: int64[K]; y: float32[n]; hap: bool[K]
    for "mixed", else None.  Returns float32[K] (see the module
    docstring)."""
    H = vals.shape[1]
    h = torch.arange(H, device=vals.device)
    w = y.index_select(0, h if mode == "haploid" else h >> 1)
    rows = vals.index_select(0, keep).to(torch.float32)
    if mode != "mixed":
        return rows @ w
    w_even = torch.where(h % 2 == 0, w, torch.zeros_like(w))
    return torch.where(hap.to(torch.bool), rows @ w_even, rows @ w)


def dot_rows(vals: torch.Tensor, keep: torch.Tensor, y: torch.Tensor,
             mode: str, hap: torch.Tensor | None = None) -> torch.Tensor:
    """The dots of the kept rows (see dot_rows_plain for the contract) in
    one call of csrc/dot_rows.cu's xsi_dot_rows: dot_rows_kernel, a warp a
    tile of 1024 columns of a group of rows, then dot_rows_sum_kernel, a
    warp a row.  On the CPU a keep outside [0, L) raises; on the card it
    gives NaN at that row (a check there would wait for the device)."""
    name = "dot_rows"
    if vals.dtype != torch.uint8 or vals.dim() != 2 \
            or not vals.is_contiguous():
        raise ValueError(f"{name}: vals must be a contiguous 2-D uint8 "
                         f"plane, got {vals.dtype} {tuple(vals.shape)}")
    L, H = vals.shape
    dev = vals.device
    if keep.dtype != torch.int64 or keep.dim() != 1 or keep.device != dev:
        raise ValueError(f"{name}: keep must be int64[K] on {dev}, got "
                         f"{keep.dtype} {tuple(keep.shape)} on {keep.device}")
    K = keep.shape[0]
    if mode not in DOT_MODES:
        raise ValueError(f"{name}: mode must be one of {DOT_MODES}, not "
                         f"{mode!r}")
    need = samples_needed(H, mode)
    if y.dtype != torch.float32 or y.dim() != 1 or y.device != dev \
            or y.shape[0] < need:
        raise ValueError(f"{name}: y must be float32[>= {need}] on {dev} "
                         f"for {mode} rows of {H}, got {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}")
    if (hap is not None) != (mode == "mixed"):
        raise ValueError(f"{name}: hap is given with mode 'mixed' and only "
                         f"then (mode {mode!r})")
    if hap is not None and (hap.dtype not in (torch.bool, torch.uint8)
                            or tuple(hap.shape) != (K,)
                            or hap.device != dev):
        raise ValueError(f"{name}: hap must be bool[{K}] on {dev}, got "
                         f"{hap.dtype} {tuple(hap.shape)} on {hap.device}")
    if dev.type == "cpu":
        if K and (int(keep.min()) < 0 or int(keep.max()) >= L):
            raise ValueError(f"{name}: keep holds a line outside [0, {L})")
        return dot_rows_plain(vals, keep, y, mode, hap)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    out = torch.empty(K, dtype=torch.float32, device=dev)
    if K == 0:
        return out
    n_tiles = tiles(H)
    part = (torch.empty((K, n_tiles), dtype=torch.float32, device=dev)
            if n_tiles > 1 else None)
    keep, y = keep.contiguous(), y.contiguous()
    flags = None if hap is None else hap.contiguous().view(torch.uint8)
    _build.launch(dev, "xsi_dot_rows", vals.data_ptr(), keep.data_ptr(),
                  y.data_ptr(), None if flags is None else flags.data_ptr(),
                  None if part is None else part.data_ptr(), out.data_ptr(),
                  L, H, K, int(mode == "haploid"))
    trace.count(name, into=launches)
    return out
