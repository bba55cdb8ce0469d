"""The block decode's sparse lines: a CUDA kernel (csrc/sparse_lines.cu)
and its plain version.

Every line of a block that is not a WAH line is filled with its negation
byte across the row, then each of its stored carriers is set to 1 ^ neg:
a plain line holds 1 at its carriers and 0 elsewhere, a negated line
(whose stored indices are its REF positions) the reverse.  The WAH lines
of the same plane are left as they are: the run flush writes them
(pbwt_kernels.decode_run_flush with a line map), so each line is written
once.  This replaces the JAX decoder's XLA glue (decoder_jax
_decode_block_vals: a zeros plane, the carriers' scatter, a where with the
WAH rows and an XOR by neg over the whole plane), not a Pallas kernel.
The wrapper launches the kernel for CUDA tensors and calls the plain
version for CPU tensors; there is no fallback from one to the other.
``launches`` counts its launches; the benchmark's launch check reads only
``pbwt_kernels.launches`` and ``wah_kernels.launches``.
"""
from __future__ import annotations

import torch

from . import _build
from ..utils import trace

#: Kernel launches since the last reset (one a call: the fill, then the
#: carriers in stream order).
launches = {"sparse_lines": 0}


def sparse_lines_plain(vals: torch.Tensor, is_wah: torch.Tensor,
                       neg: torch.Tensor, car_line: torch.Tensor,
                       car_idx: torch.Tensor) -> torch.Tensor:
    """vals: uint8[L, H], its sparse rows written in place (see the module
    docstring); is_wah: bool[L]; neg: uint8[L]; car_line, car_idx:
    int64[Nc] the carriers.  Returns vals."""
    lines = torch.nonzero(~is_wah.to(torch.bool)).squeeze(1)
    vals.index_copy_(0, lines, neg.index_select(0, lines)[:, None]
                     .expand(-1, vals.shape[1]))
    vals[car_line, car_idx] = neg.index_select(0, car_line) ^ 1
    return vals


def sparse_lines(vals: torch.Tensor, is_wah: torch.Tensor,
                 neg: torch.Tensor, car_line: torch.Tensor,
                 car_idx: torch.Tensor) -> torch.Tensor:
    """The sparse lines of a block's plane (see sparse_lines_plain for the
    contract) in one call of csrc/sparse_lines.cu's xsi_sparse_lines:
    sparse_line_fill_kernel, a CTA a line, then sparse_carrier_kernel, a
    thread a carrier.  Every carrier must lie inside its line's row (the
    host parse checks each stored index against its line's width)."""
    name = "sparse_lines"
    if vals.dtype != torch.uint8 or vals.dim() != 2 \
            or not vals.is_contiguous():
        raise ValueError(f"{name}: vals must be a contiguous 2-D uint8 "
                         f"plane, got {vals.dtype} {tuple(vals.shape)}")
    L, H = vals.shape
    dev = vals.device
    for what, t, dtypes in (("is_wah", is_wah, (torch.bool, torch.uint8)),
                            ("neg", neg, (torch.uint8,))):
        if t.dtype not in dtypes or tuple(t.shape) != (L,) \
                or t.device != dev:
            raise ValueError(f"{name}: {what} must be {dtypes[0]}[{L}] on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if car_line.dtype != torch.int64 or car_idx.dtype != torch.int64 \
            or car_line.dim() != 1 or car_line.shape != car_idx.shape \
            or car_line.device != dev or car_idx.device != dev:
        raise ValueError(f"{name}: car_line and car_idx must be int64[Nc] "
                         f"on {dev}, got {car_line.dtype} "
                         f"{tuple(car_line.shape)} and {car_idx.dtype} "
                         f"{tuple(car_idx.shape)}")
    if dev.type == "cpu":
        return sparse_lines_plain(vals, is_wah, neg, car_line, car_idx)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    is_wah = is_wah.contiguous().view(torch.uint8)
    neg, car_line, car_idx = (neg.contiguous(), car_line.contiguous(),
                              car_idx.contiguous())
    _build.launch(dev, "xsi_sparse_lines", is_wah.data_ptr(),
                  neg.data_ptr(), car_line.data_ptr(), car_idx.data_ptr(),
                  vals.data_ptr(), L, H, car_line.shape[0])
    trace.count(name, into=launches)
    return vals
