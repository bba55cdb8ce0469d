"""WAH2 codec in plain PyTorch, batched over a block's lines.

Port of xsqueezeit_tpu/ops/wah_jax.py (the main-path subset).  These are
the plain versions: they run on any device, and on the CPU they stand in
for the CUDA kernels of ops/wah_kernels.py, which compute the same
functions.

torch's unsigned 16/32-bit types lack shifts and scatters on the CPU, so
everything is computed in int32/int64 and converted to uint16 at the end.
"""
from __future__ import annotations

import torch

WAH_BITS = 15
HIGH = 1 << 15
ONE = 1 << 14
MAXC = (1 << 14) - 1
ALL_SET = 0x7FFF


def n_words_for(n_bits: int) -> int:
    return (n_bits + WAH_BITS - 1) // WAH_BITS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., H] 0/1 -> int32[..., W] 15-bit LSB-first words (H padded with
    zeros)."""
    h = bits.shape[-1]
    w = n_words_for(h)
    pad = w * WAH_BITS - h
    b = bits.to(torch.int32)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    groups = b.reshape(*b.shape[:-1], w, WAH_BITS)
    shifts = torch.arange(WAH_BITS, dtype=torch.int32, device=bits.device)
    return (groups << shifts).sum(-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, h: int) -> torch.Tensor:
    """int32[..., W] words -> uint8[..., h] bits."""
    shifts = torch.arange(WAH_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WAH_BITS)[
        ..., :h].to(torch.uint8)


def wah_compress_words(words: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """RLE-compress packed 15-bit words, batched.

    words: int32[L, W] (values 0..0x7FFF).  Returns (out uint16[L, W],
    n_out int32[L]); out rows are front-packed, trailing entries zero.
    """
    L, W = words.shape
    if W >= (1 << 15):
        # the front-pack sort key packs the word index into bits 16-30
        raise ValueError(
            f"wah_compress_words supports at most 32767 words per line "
            f"(got {W}; ~491k haplotypes); shard the haplotype axis")
    dev = words.device
    words = words.to(torch.int64)
    is_zero = words == 0
    is_ones = words == ALL_SET
    is_fill = is_zero | is_ones
    idx = torch.arange(W, device=dev)[None, :].expand(L, W)

    # Run detection: class changes or literal words break runs.
    cls = torch.where(is_zero, 0, torch.where(is_ones, 1, 2 + idx))
    prev_cls = torch.cat([torch.full((L, 1), -1, device=dev), cls[:, :-1]],
                         1)
    boundary = cls != prev_cls
    run_start = torch.cummax(torch.where(boundary, idx, -1), 1).values
    pos_in_run = idx - run_start
    # Split runs at the 16383-word counter limit.
    sub_boundary = boundary | (is_fill & (pos_in_run > 0)
                               & (pos_in_run % MAXC == 0))
    sub_start = torch.cummax(torch.where(sub_boundary, idx, -1), 1).values
    sub_len = idx - sub_start + 1
    # A word emits output iff it is the last of its sub-run.
    emit = torch.cat([sub_boundary[:, 1:],
                      torch.ones((L, 1), dtype=torch.bool, device=dev)], 1)
    fill_word = HIGH | torch.where(is_ones, ONE, 0) | sub_len
    out_val = torch.where(is_fill, fill_word, words)

    # Front-pack: each emitted word goes to its rank among the row's
    # emitted words; the others go to a spill column that is cut off.
    n_out = emit.sum(1, dtype=torch.int32)
    dest = torch.where(emit, torch.cumsum(emit, 1) - 1, W)
    out = torch.zeros((L, W + 1), dtype=torch.int64, device=dev)
    out.scatter_(1, dest, torch.where(emit, out_val, 0))
    return out[:, :W].to(torch.uint16), n_out


def wah_encode_lines(bits: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """bits uint8/bool[L, H] -> (words uint16[L, W], n_words int32[L]):
    pack_bits then wah_compress_words (wah_jax.wah_encode_lines)."""
    return wah_compress_words(pack_bits(bits))


def wah_word_offsets(stream: torch.Tensor,
                     group_off: torch.Tensor) -> torch.Tensor:
    """Word offset of each line, and of the end of the last one, in a WAH
    stream whose line l spans groups [group_off[l], group_off[l+1]).

    stream: uint16/int32[N]; group_off: int64[n_lines + 1] ascending.
    Returns int64[n_lines + 1]; lines past the stream's end get offset N.
    One cumsum over the words' spans plus a searchsorted, as
    wah_jax.wah_line_offsets (fill counters never straddle a line).  The
    CUDA routes find the same offsets without it (csrc/wah.cu: a span scan
    and a search per line).
    """
    s = stream.to(torch.int32)
    span = torch.where((s & HIGH) != 0, s & MAXC, 1).to(torch.int64)
    return torch.searchsorted(torch.cumsum(span, 0), group_off, right=True)


def wah_line_offsets(stream: torch.Tensor, w: int,
                     n_lines: int) -> torch.Tensor:
    """wah_word_offsets of a uniform-width stream (every line spans
    exactly w 15-bit groups)."""
    return wah_word_offsets(stream, torch.arange(
        n_lines + 1, dtype=torch.int64, device=stream.device) * w)


def _covered_groups(z: torch.Tensor, pos_row: torch.Tensor) -> torch.Tensor:
    """The 15-bit groups of rows z (int64[n, w], per row the cumulative
    max of (word's end in its row << 16) | word planted at each word's
    first group in the row) at positions pos_row: a group takes the last
    word starting at or before it if that word still covers it, else 0."""
    word = torch.where((z >> 16) > pos_row, z & 0xFFFF, 0)
    fill = torch.where((word & ONE) != 0, ALL_SET, 0)
    return torch.where((word & HIGH) != 0, fill, word)


def wah_expand_stream(stream: torch.Tensor, n_lines: int,
                      w: int) -> torch.Tensor:
    """Expand a concatenated uniform-width WAH stream to 15-bit groups.

    stream: uint16/int32[N] -- the WAH words of `n_lines` lines back to
    back, each line spanning exactly `w` groups.  Words whose groups fall
    past n_lines*w are dropped, so zero-padded tails and short streams
    give all-zero rows.  A corrupt stream decodes as csrc/wah.cu's expand
    reads it: a group takes the word covering it if that word ends within
    the group's line, else 0 (a counter that runs past its line counts
    only in the line it ends in).

    Returns int32[n_lines, w] (counters resolved to 0 / 0x7FFF fills), as
    wah_jax.wah_expand_stream does for a well-formed stream.  A global
    cumsum of the spans places every word, a scatter plants ((its end in
    its row) << 16 | word) at its first group in the row it ends in, and
    a per-row cumulative max forward-fills it up to its end.
    """
    if w >= (1 << 15):
        raise ValueError(
            f"wah_expand_stream supports at most 32767 words per line "
            f"(got {w}); shard the haplotype axis")
    dev = stream.device
    s = stream.to(torch.int64)
    span = torch.where((s & HIGH) != 0, s & MAXC, 1)
    end = torch.cumsum(span, 0)
    lo = torch.div(end - 1, w, rounding_mode="floor") * w
    cap = n_lines * w
    dest = torch.where(span > 0, torch.maximum(end - span, lo), cap)
    z = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    z.scatter_(0, torch.clamp(dest, max=cap), ((end - lo) << 16) | s)
    z = torch.cummax(z[:cap].reshape(n_lines, w), 1).values
    return _covered_groups(z, torch.arange(w, device=dev)).to(torch.int32)


def wah_expand_stream_varw(stream: torch.Tensor, group_off: torch.Tensor,
                           w_max: int) -> torch.Tensor:
    """wah_expand_stream for per-line widths (mixed-ploidy blocks: haploid
    lines span n_words_for(N) groups, diploid n_words_for(2N)).

    group_off: int64[n_lines + 1] cumulative group offsets of the lines.
    Returns int32[n_lines, w_max]; groups past a line's own width are
    zero.  wah_jax.wah_expand_stream_varw for a well-formed stream, and
    the kernel's reading of a corrupt one, as wah_expand_stream: each
    word's row is found by a searchsorted on group_off.
    """
    if w_max >= (1 << 15):
        raise ValueError(
            f"wah_expand_stream_varw supports at most 32767 words per line "
            f"(got {w_max})")
    dev = stream.device
    n_lines = group_off.shape[0] - 1
    group_off = group_off.to(torch.int64)
    s = stream.to(torch.int64)
    span = torch.where((s & HIGH) != 0, s & MAXC, 1)
    end = torch.cumsum(span, 0)
    line_of = torch.searchsorted(group_off, end - 1, right=True) - 1
    line_c = torch.clamp(line_of, 0, max(n_lines - 1, 0))
    lo = group_off[line_c]
    pos = torch.maximum(end - span, lo) - lo
    cap = n_lines * w_max
    valid = ((span > 0) & (line_of >= 0) & (line_of < n_lines)
             & (pos < w_max))
    dest = torch.where(valid, line_c * w_max + pos, cap)
    z = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    z.scatter_(0, dest, (torch.clamp(end - lo, max=w_max) << 16) | s)
    z = torch.cummax(z[:cap].reshape(n_lines, w_max), 1).values
    pos_row = torch.arange(w_max, device=dev)
    out = _covered_groups(z, pos_row)
    widths = group_off[1:] - group_off[:-1]
    keep = pos_row[None, :] < widths[:, None]
    return torch.where(keep, out, 0).to(torch.int32)


def wah_expand_stream_bits(stream: torch.Tensor, n_lines: int, w: int,
                           h: int) -> torch.Tensor:
    """wah_expand_stream then unpack_bits: uint8[n_lines, h] bits (the
    JAX package's wah_decode_lines over wah_line_offsets)."""
    return unpack_bits(wah_expand_stream(stream, n_lines, w), h)


def wah_expand_stream_varw_bits(stream: torch.Tensor,
                                group_off: torch.Tensor, w_max: int,
                                h: int) -> torch.Tensor:
    """wah_expand_stream_varw then unpack_bits: uint8[n_lines, h] bits, 0
    past each line's own groups."""
    return unpack_bits(wah_expand_stream_varw(stream, group_off, w_max), h)
