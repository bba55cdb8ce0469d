"""WAH2 expand and compress: CUDA kernels (csrc/wah.cu) and their plain
versions.

Port of xsqueezeit_tpu/ops/wah_pallas.py, plus a per-line-width route of
the expand for mixed-ploidy blocks (wah_expand_varw, in place of the XLA
wah_jax.wah_expand_stream_varw).  Each wrapper launches its kernel for a
CUDA tensor and calls the plain version for a CPU tensor; there is no
fallback from one to the other.  ``launches`` counts kernel launches per
kernel name.
"""
from __future__ import annotations

import torch

from . import _build
from .wah_torch import (
    wah_compress_words as wah_compress_plain,
    wah_expand_stream as wah_expand_plain,
    wah_expand_stream_varw as wah_expand_varw_plain,
    wah_line_offsets,
    wah_word_offsets,
)

#: Kernel launches since the last reset, by kernel name.
launches = {"wah_expand": 0, "wah_expand_varw": 0, "wah_compress": 0}


def _check_stream(name: str, stream: torch.Tensor, w: int,
                  n_lines: int) -> torch.Tensor:
    if stream.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {stream.device}")
    if stream.dtype != torch.uint16 or stream.dim() != 1:
        raise ValueError(f"{name}: stream must be 1-D uint16, got "
                         f"{stream.dtype} {tuple(stream.shape)}")
    if not 1 <= w < (1 << 15) or n_lines < 0:
        raise ValueError(f"{name}: need 1 <= w <= 32767 words per line "
                         f"and n_lines >= 0 (got w={w}, n_lines={n_lines})")
    return stream.contiguous()


def wah_expand(stream: torch.Tensor, n_lines: int, w: int) -> torch.Tensor:
    """Expand a uniform-width WAH stream to int32[n_lines, w] 15-bit groups.

    Same contract as wah_torch.wah_expand_stream (and the Pallas
    wah_expand_pallas): stream uint16[N] holds the words of n_lines lines
    of w groups each, back to back; a zero-padded tail and lines past the
    stream's end decode to zero rows.
    """
    if stream.device.type == "cpu":
        return wah_expand_plain(stream, n_lines, w)
    stream = _check_stream("wah_expand", stream, w, n_lines)
    offs = wah_line_offsets(stream, w, n_lines)
    out = torch.empty((n_lines, w), dtype=torch.int32, device=stream.device)
    _build.launch(stream.device, "xsi_wah_expand", stream.data_ptr(),
                  offs.data_ptr(), out.data_ptr(), n_lines, w)
    launches["wah_expand"] += 1
    return out


def wah_expand_varw(stream: torch.Tensor, group_off: torch.Tensor,
                    w_max: int) -> torch.Tensor:
    """Expand a WAH stream of per-line widths to int32[n_lines, w_max].

    Same contract as wah_torch.wah_expand_stream_varw: line l spans groups
    [group_off[l], group_off[l+1]) (int64[n_lines + 1], each width at most
    w_max); groups past a line's width are zero.
    """
    if stream.device.type == "cpu":
        return wah_expand_varw_plain(stream, group_off, w_max)
    n_lines = group_off.shape[0] - 1
    stream = _check_stream("wah_expand_varw", stream, w_max, n_lines)
    if group_off.dtype != torch.int64 or group_off.device != stream.device:
        raise ValueError(f"wah_expand_varw: group_off must be int64 on "
                         f"{stream.device}, got {group_off.dtype} on "
                         f"{group_off.device}")
    group_off = group_off.contiguous()
    offs = wah_word_offsets(stream, group_off)
    out = torch.empty((n_lines, w_max), dtype=torch.int32,
                      device=stream.device)
    _build.launch(stream.device, "xsi_wah_expand_varw", stream.data_ptr(),
                  offs.data_ptr(), group_off.data_ptr(), out.data_ptr(),
                  n_lines, w_max)
    launches["wah_expand_varw"] += 1
    return out


def wah_compress(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """WAH2 RLE of packed 15-bit words: int32[L, w] (values 0..0x7FFF) ->
    (uint16[L, w] front-packed words, int32[L] word counts), exactly
    wah_torch.wah_compress_words."""
    if words.device.type == "cpu":
        return wah_compress_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"wah_compress: unsupported device {words.device}")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"wah_compress: words must be 2-D int32, got "
                         f"{words.dtype} {tuple(words.shape)}")
    L, w = words.shape
    if w >= (1 << 15):
        raise ValueError(
            f"wah_compress supports at most 32767 words per line (got {w})")
    words = words.contiguous()
    out = torch.empty((L, w), dtype=torch.uint16, device=words.device)
    n_out = torch.empty(L, dtype=torch.int32, device=words.device)
    _build.launch(words.device, "xsi_wah_compress", words.data_ptr(),
                  out.data_ptr(), n_out.data_ptr(), L, w)
    launches["wah_compress"] += 1
    return out, n_out
