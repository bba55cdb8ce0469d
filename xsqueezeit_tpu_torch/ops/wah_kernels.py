"""WAH2 expand and compress: CUDA kernels (csrc/wah.cu) and their plain
versions.

Port of xsqueezeit_tpu/ops/wah_pallas.py, plus a per-line-width route of
the expand for mixed-ploidy blocks (wah_expand_varw, in place of the XLA
wah_jax.wah_expand_stream_varw).  The int32-group routes (wah_expand,
wah_expand_varw, wah_compress) keep the TPU kernels' contract; the bits
routes (wah_expand_bits, wah_expand_varw_bits, wah_compress_bits) fuse
unpack_bits / pack_bits into the same kernels and are what the codec
calls.  Each wrapper launches its kernel for a CUDA tensor and calls the
plain version for a CPU tensor; there is no fallback from one to the
other.  ``launches`` counts kernel launches per route.
"""
from __future__ import annotations

import torch

from . import _build
from ..utils import trace
from .wah_torch import (
    n_words_for,
    wah_compress_words as wah_compress_plain,
    wah_encode_lines as wah_compress_bits_plain,
    wah_expand_stream as wah_expand_plain,
    wah_expand_stream_bits as wah_expand_bits_plain,
    wah_expand_stream_varw as wah_expand_varw_plain,
    wah_expand_stream_varw_bits as wah_expand_varw_bits_plain,
)

#: Kernel launches since the last reset, by route.
launches = {"wah_expand": 0, "wah_expand_varw": 0, "wah_compress": 0,
            "wah_expand_bits": 0, "wah_expand_varw_bits": 0,
            "wah_compress_bits": 0}

#: Shared memory one CTA may use on an H100 (bytes).
SMEM_LIMIT = 232448
#: Widths up to this many groups expand with a warp per line, wider ones
#: with a CTA of 256 threads per line.
WARP_LINE_MAX_W = 512
#: Words per tile of the span scan (csrc/wah.cu SCAN_TILE).
SCAN_TILE = 4096
#: Groups a stream's lines may span: the span prefix is int32.
MAX_GROUPS = (1 << 31) - 2


def expand_smem_bytes(w_row: int, line_threads: int) -> int:
    """Dynamic shared memory of an expand CTA (csrc/wah.cu
    expand_line_smem): per line a start and a word per word slot and
    w_row + 2 groups.  A warp per line, four lines to a CTA, keeps int
    starts (up to w = 7263); a CTA per line 16-bit ones, so it takes every
    width the format allows (w <= 32,767: 196,606 bytes)."""
    if line_threads == 32:
        return 4 * (w_row * 8 + 4)
    return w_row * 6 + 4


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
    if n_lines * w > MAX_GROUPS:
        raise ValueError(f"{name}: {n_lines} lines of {w} groups exceed the "
                         f"int32 span prefix ({MAX_GROUPS} groups)")
    return stream.contiguous()


def _check_bits_out(name: str, out: torch.Tensor | None, n_lines: int,
                    h: int, device: torch.device) -> None:
    if out is not None and (out.dtype != torch.uint8
                            or tuple(out.shape) != (n_lines, h)
                            or out.device != device
                            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous uint8"
                         f"[{n_lines}, {h}] on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")


def _expand(name: str, stream: torch.Tensor, n_lines: int, w: int,
            group_off: torch.Tensor | None, h: int | None,
            line_threads: int | None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the span scan and the expand kernel of one route: int32
    groups [n_lines, w] (h None) or uint8 bits [n_lines, h], into `out`
    where given (bits routes)."""
    stream = _check_stream(name, stream, w, n_lines)
    if line_threads is None:
        line_threads = 32 if w <= WARP_LINE_MAX_W else 256
    if line_threads not in (32, 256):
        raise ValueError(f"{name}: line_threads must be 32 or 256 "
                         f"(got {line_threads})")
    if expand_smem_bytes(w, line_threads) > SMEM_LIMIT:
        raise ValueError(f"{name}: w={w} needs more shared memory than a "
                         f"CTA has with line_threads={line_threads}")
    if h is not None and not 0 <= h <= 15 * w:
        raise ValueError(f"{name}: need 0 <= h <= 15 * w (got h={h}, w={w})")
    dev = stream.device
    n = stream.shape[0]
    cum = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(-(-n // SCAN_TILE) + 1, dtype=torch.int64,
                         device=dev)
    if h is None:
        out = torch.empty((n_lines, w), dtype=torch.int32, device=dev)
    elif out is None:
        out = torch.empty((n_lines, h), dtype=torch.uint8, device=dev)
    _build.launch(dev, "xsi_wah_expand", stream.data_ptr(), n,
                  cum.data_ptr(), status.data_ptr(),
                  0 if group_off is None else group_off.data_ptr(),
                  out.data_ptr(), n_lines, w, w if h is None else h,
                  int(group_off is not None), int(h is not None),
                  line_threads)
    trace.count(name, into=launches)
    return out


def _check_group_off(name: str, group_off: torch.Tensor,
                     device: torch.device) -> torch.Tensor:
    if group_off.dtype != torch.int64 or group_off.device != device:
        raise ValueError(f"{name}: group_off must be int64 on {device}, got "
                         f"{group_off.dtype} on {group_off.device}")
    return group_off.contiguous()


def wah_expand(stream: torch.Tensor, n_lines: int, w: int,
               line_threads: int | None = None) -> torch.Tensor:
    """Expand a uniform-width WAH stream to int32[n_lines, w] 15-bit groups.

    Same contract as wah_torch.wah_expand_stream (and the Pallas
    wah_expand_pallas): stream uint16[N] holds the words of n_lines lines
    of w groups each, back to back; a zero-padded tail and lines past the
    stream's end decode to zero rows.  line_threads: 32 (a warp per line)
    or 256 (a CTA per line); None picks by width.
    """
    if stream.device.type == "cpu":
        return wah_expand_plain(stream, n_lines, w)
    return _expand("wah_expand", stream, n_lines, w, None, None,
                   line_threads)


def wah_expand_bits(stream: torch.Tensor, n_lines: int, w: int, h: int,
                    line_threads: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """wah_expand and unpack_bits in one kernel: uint8[n_lines, h] bits
    (wah_torch.wah_expand_stream_bits; the JAX package's
    wah_decode_lines), written into `out` (a contiguous uint8[n_lines, h],
    such as the leading rows of a larger buffer) where given."""
    _check_bits_out("wah_expand_bits", out, n_lines, h, stream.device)
    if stream.device.type == "cpu":
        bits = wah_expand_bits_plain(stream, n_lines, w, h)
        return bits if out is None else out.copy_(bits)
    return _expand("wah_expand_bits", stream, n_lines, w, None, h,
                   line_threads, out)


def wah_expand_varw(stream: torch.Tensor, group_off: torch.Tensor,
                    w_max: int, line_threads: int | None = None
                    ) -> torch.Tensor:
    """Expand a WAH stream of per-line widths to int32[n_lines, w_max].

    Same contract as wah_torch.wah_expand_stream_varw: line l spans groups
    [group_off[l], group_off[l+1]) (int64[n_lines + 1], each width at most
    w_max); groups past a line's width are zero.
    """
    if stream.device.type == "cpu":
        return wah_expand_varw_plain(stream, group_off, w_max)
    group_off = _check_group_off("wah_expand_varw", group_off,
                                 stream.device)
    return _expand("wah_expand_varw", stream, group_off.shape[0] - 1, w_max,
                   group_off, None, line_threads)


def wah_expand_varw_bits(stream: torch.Tensor, group_off: torch.Tensor,
                         w_max: int, h: int,
                         line_threads: int | None = None) -> torch.Tensor:
    """wah_expand_varw and unpack_bits in one kernel: uint8[n_lines, h]
    bits, 0 past each line's own groups
    (wah_torch.wah_expand_stream_varw_bits)."""
    if stream.device.type == "cpu":
        return wah_expand_varw_bits_plain(stream, group_off, w_max, h)
    group_off = _check_group_off("wah_expand_varw_bits", group_off,
                                 stream.device)
    return _expand("wah_expand_varw_bits", stream, group_off.shape[0] - 1,
                   w_max, group_off, h, line_threads)


def _compress(name: str, src: torch.Tensor, ld: int, L: int, w: int,
              h: int, bits: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if w >= (1 << 15):
        raise ValueError(
            f"{name} supports at most 32767 words per line (got {w})")
    out = torch.empty((L, w), dtype=torch.uint16, device=src.device)
    n_out = torch.empty(L, dtype=torch.int32, device=src.device)
    _build.launch(src.device, "xsi_wah_compress", src.data_ptr(), ld,
                  out.data_ptr(), n_out.data_ptr(), L, w, h, int(bits))
    trace.count(name, into=launches)
    return out, n_out


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
    return _compress("wah_compress", words.contiguous(), w, L, w, 15 * w,
                     False)


def wah_compress_bits(bits: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """pack_bits and the WAH2 RLE in one kernel: uint8/bool[R, H] 0/1 bit
    rows -> (uint16[R, W] front-packed words, int32[R] word counts), W =
    ceil(H / 15); exactly wah_torch.wah_encode_lines.  Rows may be strided
    (a column slice of a wider matrix needs no copy)."""
    if bits.device.type == "cpu":
        return wah_compress_bits_plain(bits)
    if bits.device.type != "cuda":
        raise ValueError(f"wah_compress_bits: unsupported device "
                         f"{bits.device}")
    if bits.dtype not in (torch.uint8, torch.bool) or bits.dim() != 2:
        raise ValueError(f"wah_compress_bits: bits must be 2-D uint8 or "
                         f"bool, got {bits.dtype} {tuple(bits.shape)}")
    R, H = bits.shape
    if bits.stride(1) != 1 or (R > 1 and bits.stride(0) < H):
        bits = bits.contiguous()
    return _compress("wah_compress_bits", bits, bits.stride(0), R,
                     n_words_for(H), H, True)
