"""PBWT arrangement transforms in PyTorch: the chunked encode and decode.

Port of xsqueezeit_tpu/ops/pbwt_jax.py (pbwt_encode_chunked,
pbwt_decode_chunked, _rank_chain).  Lines group into chunks of C = 16; a
16-bit register per haplotype carries the chunk's bits through the
partitions, which run in the chunk-chain kernels of ops/pbwt_kernels.py.
Cross-chunk state comes from a rank chain (encode) or from composing the
chunks' arrangements (decode).

Where the JAX package applies permutations with packed row sorts (fast on a
TPU), this module scatters and gathers.  The block-start arrangement is the
identity (header iota_ppa).
"""
from __future__ import annotations

import torch

from . import pbwt_kernels

DECODE_CHUNK = 16


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of each row permutation of the last axis."""
    iota = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, iota)


def _rank_chain(T: torch.Tensor, r0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-start rank chain: r_{t+1} = rank of each haplotype by
    (T_t, r_t).

    T: int64[n_ch, H] per-chunk history totals (latest sorting bit
    highest, < 2^16); r0: int64[H].  Returns (r_final int64[H], r_starts
    int64[n_ch, H]).  One chunk per step: the key (T_t << 16) | r_t is
    unique per haplotype (ranks are), so one sort per chunk orders it.
    """
    n_ch, H = T.shape
    r = r0
    r_starts = torch.empty((n_ch, H), dtype=torch.int64, device=T.device)
    for t in range(n_ch):
        r_starts[t] = r
        order = torch.argsort((T[t] << 16) | r)
        r = _inverse(order)
    return r, r_starts


def pbwt_encode_chunked(alleles: torch.Tensor, alts: torch.Tensor,
                        sorts: torch.Tensor, chunk: int = 16
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Arrangement-ordered bits for every line (H <= 65535).

    alleles: int8/int16[L, H] allele codes; alts: int32[L] target ALT per
    line; sorts: bool[L] whether the line updates the arrangement.
    Returns (ys uint8[L, H], a_final int64[H]).
    """
    L, H = alleles.shape
    if H > 65535:
        raise ValueError("pbwt_encode_chunked requires H <= 65535")
    dev = alleles.device
    C = chunk
    x = alleles == alts[:, None]
    pad = (-L) % C
    sorts = sorts.to(torch.bool)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        sorts = torch.nn.functional.pad(sorts, (0, pad))
    n_ch = (L + pad) // C
    xc = x.reshape(n_ch, C, H)

    # Registers (bit j = chunk line j) and chunk history totals over the
    # sorting lines (latest sorting bit highest), one line at a time so
    # the temporaries stay [n_ch, H] (at HRC width a [n_ch, C, H] int64
    # grid would be over 2 GB).
    ss = sorts.reshape(n_ch, C)
    ssi = ss.to(torch.int64)
    sh = torch.cumsum(ssi, 1) - ssi
    bhat = torch.zeros((n_ch, H), dtype=torch.int64, device=dev)
    T = torch.zeros((n_ch, H), dtype=torch.int64, device=dev)
    for j in range(C):
        xj = xc[:, j].to(torch.int64)
        bhat |= xj << j
        T |= (xj << sh[:, j:j + 1]) & -ssi[:, j:j + 1]

    iota = torch.arange(H, device=dev)
    r_fin, r_starts = _rank_chain(T, iota)

    # Register load: each haplotype's register lands at its chunk-start slot.
    q0 = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    q0.scatter_(1, r_starts, bhat.to(torch.int32))
    ys = pbwt_kernels.chain_encode(q0, ss)
    return ys.reshape(n_ch * C, H)[:L], _inverse(r_fin)


def _compose_prefix(o_tot: torch.Tensor) -> torch.Tensor:
    """Arrangement at the end of every chunk: inc[t] = inc[t-1][o_tot[t]]
    (inc[-1] = identity), as a log-step doubling scan of gathers."""
    inc = o_tot.clone()
    d = 1
    while d < inc.shape[0]:
        inc[d:] = torch.gather(inc[:-d], 1, inc[d:])
        d <<= 1
    return inc


def pbwt_decode_chunked(ys: torch.Tensor, sorts: torch.Tensor,
                        chunk: int = DECODE_CHUNK
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked PBWT decode (H <= 65535): bits back to natural order.

    ys: uint8[L, H] bits in arrangement order; sorts: bool[L] (all-zero
    padding rows may pass True).  Returns (vals uint8[L, H] natural-order
    bits, a_final int64[H]).
    """
    L, H = ys.shape
    if H > 65535:
        raise ValueError("pbwt_decode_chunked requires H <= 65535")
    dev = ys.device
    C = chunk
    pad = (-L) % C
    sorts = sorts.to(torch.bool)
    y = ys.to(torch.uint8)
    if pad:
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        sorts = torch.nn.functional.pad(sorts, (0, pad))
    n_ch = (L + pad) // C
    p_fin = pbwt_kernels.chain_decode(y.reshape(n_ch, C, H),
                                      sorts.reshape(n_ch, C))
    o_tot = p_fin >> 16                     # chunk-start slot per end slot
    beta = p_fin & 0xFFFF
    inc = _compose_prefix(o_tot)            # haplotype per end slot
    X = torch.empty_like(beta).scatter_(1, inc, beta)   # natural order
    # one line at a time: temporaries stay [n_ch, H]
    vals = torch.empty((n_ch, C, H), dtype=torch.uint8, device=dev)
    for j in range(C):
        vals[:, j] = (X >> j) & 1
    return vals.reshape(n_ch * C, H)[:L], inc[-1]
