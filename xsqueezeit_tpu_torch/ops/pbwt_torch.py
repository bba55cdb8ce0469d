"""PBWT arrangement transforms in PyTorch: the chunked encode and decode
at every width, and the mixed-ploidy decode.

Port of xsqueezeit_tpu/ops/pbwt_jax.py, whose forms the tests hold these
against: pbwt_encode_chunked has the contracts of
pbwt_jax.pbwt_encode_scan and pbwt_jax.pbwt_encode_scan_parity at every
width, pbwt_decode_chunked that of pbwt_jax.pbwt_decode_blocked, and
pbwt_decode_scan_mixed that of pbwt_jax.pbwt_decode_scan_mixed; its
_rank_chain is ops/pbwt_kernels.py rank_chain.  The
encode groups lines into chunks of C = 16 at every width: a 16-bit
register per haplotype carries the chunk's bits through the partitions,
which run in the chunk-chain kernels of ops/pbwt_kernels.py; the
mixed-ploidy encode takes chunks of 15 lines and carries the haplotype's
slot parity in the register's bit 15 (pbwt_encode_chunked(...,
parity=True)).  The decode's chain carries (chunk-start slot << C) | beta
in 32 bits, so its chunks hold C = 16 lines up to 65,536 haplotypes and
C = 32 - ceil(log2 H) above (pbwt_kernels.decode_chunk).  Cross-chunk
state comes from a rank chain (encode: the rank_chain kernels) or from
composing the chunks' arrangements (decode: the run flush kernel composes
them and writes the rows).  The chains take every width the format
allows (the decode above one CTA's 28,928 haplotypes with its rows in
device memory).  Mixed-ploidy blocks decode run by run
(pbwt_decode_scan_mixed): a long run of one ploidy is a uniform chunked
decode (at width ceil(H / 2) for a haploid run, over the samples) with
the run flush kernel, and short runs take the stepping kernel.  On the
CPU every kernel wrapper runs its plain version.

Where the JAX package applies permutations with packed row sorts (fast on a
TPU), this module scatters and gathers.  The block-start arrangement is the
identity (header iota_ppa).
"""
from __future__ import annotations

import numpy as np
import torch

from . import pbwt_kernels
from ..utils import trace

#: Runs of one ploidy shorter than this many WAH lines take the mixed
#: scan's stepping kernel, longer ones the chunk chains.  On an H100 the
#: stepping kernel took about 3 us a line while its state fits shared
#: memory (H <= 17,801); a run on the chains took 0.2-0.6 ms whatever its
#: length, almost all of it the host's launches, so the crossover follows
#: the host's speed.  At chrX PAR width runs of 256 lines won in every
#: sweep of the final route, by at least 1.4x; runs of 128 won in some
#: sweeps and lost in others.  Where the stepping state lives in device
#: memory (about 120 us a line) the chains won from runs of 8 lines
#: (MIN_RUN_LINES_WIDE).  PERF.md §6 has every sweep (chip_smoke.py).
MIN_RUN_LINES = 256
MIN_RUN_LINES_WIDE = 16


_inverse = pbwt_kernels._inverse


def _hap_bits(h: int) -> int:
    return max(int(h - 1).bit_length(), 1)


def pbwt_encode_chunked(alleles: torch.Tensor, alts: torch.Tensor,
                        sorts: torch.Tensor, chunk: int = 16,
                        parity: bool = False) -> tuple[torch.Tensor, ...]:
    """Arrangement-ordered bits for every line, at every width up to
    pbwt_kernels.MAX_RANK_H = 491,505: the rank chain, the register load
    and chain_encode (one CTA, or a cluster of 8 or 16).

    alleles: int8/int16[L, H] allele codes; alts: int32[L] target ALT per
    line; sorts: bool[L] whether the line updates the arrangement.
    Returns (ys uint8[L, H], a_final int64[H]).  With `parity` (the
    mixed-ploidy encode) the chunks hold at most pbwt_kernels.PARITY_CHUNK
    = 15 lines, bit 15 of each register is the haplotype's slot parity h &
    1, and chain_encode emits it beside each line's bit: returns (ys, par
    uint8[L, H] the parity of the haplotype at each position, a_final),
    the contract of pbwt_jax.pbwt_encode_scan_parity.
    """
    L, H = alleles.shape
    if H > pbwt_kernels.MAX_RANK_H:
        raise ValueError(f"pbwt_encode_chunked takes at most "
                         f"{pbwt_kernels.MAX_RANK_H} haplotypes (got {H})")
    dev = alleles.device
    C = min(chunk, pbwt_kernels.PARITY_CHUNK) if parity else chunk
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
    ssi = ss.to(torch.int32)
    sh = torch.cumsum(ssi, 1, dtype=torch.int32) - ssi
    bhat = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    T = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    for j in range(C):
        xj = xc[:, j].to(torch.int32)
        bhat |= xj << j
        T |= (xj << sh[:, j:j + 1]) & -ssi[:, j:j + 1]

    iota = torch.arange(H, device=dev)
    r_fin, r_starts = pbwt_kernels.rank_chain(T, iota,
                                             max(16, _hap_bits(H)))
    if parity:
        bhat |= (iota.to(torch.int32) & 1) << 15

    # Register load: each haplotype's register lands at its chunk-start slot.
    q0 = torch.zeros((n_ch, H), dtype=torch.int32, device=dev)
    q0.scatter_(1, r_starts, bhat)
    ys = pbwt_kernels.chain_encode(q0, ss, parity=parity)
    ys = ys.reshape(n_ch * C, H)[:L]
    if not parity:
        return ys, _inverse(r_fin)
    par = ys >> 1
    return ys.bitwise_and_(1), par, _inverse(r_fin)


def chunk_rows(n: int, W: int) -> int:
    """Rows of the whole chunks n lines fill in the decode at W slots
    (chunks of pbwt_kernels.decode_chunk(W) lines)."""
    C = pbwt_kernels.decode_chunk(W)
    return -(-n // C) * C


def pbwt_decode_chunked(ys: torch.Tensor, sorts: torch.Tensor,
                        out: torch.Tensor | None = None,
                        line_of: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked PBWT decode, at every width up to pbwt_kernels.MAX_RANK_H =
    491,505: bits back to natural order, block start at the identity.  A
    diploid run of the mixed scan's run route from the identity
    (_decode_run): the chunk chains, then the run flush.

    ys: uint8[n, H] bits in arrangement order, or uint8[chunk_rows(n, H),
    H] with zero rows past the n lines (whole chunks: nothing is then
    copied); sorts: bool[n].  out: None, or the uint8[L, H] plane to write
    the rows into, row k at out[line_of[k]] with a line map line_of (int32
    or int64[n]), else at row k (L = n).  Returns (vals uint8[n, H]
    natural-order bits, or `out`; a_final int64[H]).
    """
    H = ys.shape[1]
    n = sorts.shape[0]
    if H > pbwt_kernels.MAX_RANK_H:
        raise ValueError(f"pbwt_decode_chunked takes at most "
                         f"{pbwt_kernels.MAX_RANK_H} haplotypes (got {H})")
    vals = (torch.empty((n, H), dtype=torch.uint8, device=ys.device)
            if out is None else out)
    if n == 0:
        return vals, torch.arange(H, device=ys.device)
    a_fin = _decode_run(ys.to(torch.uint8), sorts,
                        torch.arange(H, device=ys.device), False, vals,
                        end=True, line_of=line_of)
    return vals, a_fin


def mixed_runs(hap: np.ndarray, H: int) -> list[tuple[int, int, str]]:
    """The pieces the mixed scan decodes a block's WAH lines in, from the
    host's haploid flags: [(first line, end line, route)], route "diploid"
    or "haploid" for a maximal run of one ploidy of at least MIN_RUN_LINES
    lines (MIN_RUN_LINES_WIDE where the stepping kernel's state does not
    fit shared memory), at any width (H, or ceil(H / 2) samples), else
    "step" (the stepping kernel), consecutive such runs in one piece."""
    hap = np.asarray(hap, dtype=bool)
    cuts = np.flatnonzero(hap[1:] != hap[:-1]) + 1
    short = (MIN_RUN_LINES_WIDE if pbwt_kernels.mixed_smem_bytes(H)
             > pbwt_kernels._SMEM_BYTES else MIN_RUN_LINES)
    pieces: list[tuple[int, int, str]] = []
    for a, b in zip([0, *cuts.tolist()], [*cuts.tolist(), hap.shape[0]]):
        if b <= a:
            continue
        route = ("step" if b - a < short
                 else "haploid" if hap[a] else "diploid")
        if route == "step" and pieces and pieces[-1][2] == "step":
            pieces[-1] = (pieces[-1][0], b, route)
        else:
            pieces.append((a, b, route))
    return pieces


def decode_routes(W: int, device: torch.device) -> tuple[str, str]:
    """The routes a run of W slots takes on `device`, as the decode.chain
    and decode.flush spans name them: the chain on one CTA ("cta") or on
    16 CTAs with its rows in device memory ("rows"), the run flush on a CTA
    a chunk ("cta") or a cluster of pbwt_kernels.FLUSH_CLUSTER CTAs
    ("cluster"); ("plain", "plain") on the CPU, where the plain versions
    run."""
    if device.type == "cpu":
        return "plain", "plain"
    chain = ("cta" if pbwt_kernels.cluster_size("chain_decode", W) == 1
             else "rows")
    return chain, "cta" if pbwt_kernels.flush_cluster(W) == 1 else "cluster"


def _decode_run(ys: torch.Tensor, sorts: torch.Tensor, a: torch.Tensor,
                haploid: bool, out: torch.Tensor, end: bool,
                line_of: torch.Tensor | None = None) -> torch.Tensor | None:
    """One run of a ploidy as a uniform chunked decode from the
    arrangement a: its n = len(sorts) rows into `out` (row k at
    out[line_of[k]] with a line map); returns the arrangement after it
    (None where `end` is false).  ys holds the n lines, or whole chunks of
    rows with zero rows past them (then nothing is copied; a run of fewer
    lines is padded to whole chunks here).  A haploid run decodes over the samples,
    from their order E = a[a even] >> 1 (a line stably partitions the even
    slots by its stored bits), and its end arrangement is the rank chain of
    the histories the flush writes, from the ranks inverse(a).  Chunks
    hold pbwt_kernels.decode_chunk(W) lines, the chain states' shift (16
    up to 65,536 slots).  Spans (utils/trace.py): decode.chain around the
    chains (width W, chunk_lines C, route; counter decode.chunks, the
    chunks) and decode.flush around the run flush (route, and the shapes
    its byte bound reads)."""
    rows, H = ys.shape
    n = sorts.shape[0]
    dev = ys.device
    W = (H + 1) // 2 if haploid else H
    C = pbwt_kernels.decode_chunk(W)
    n_ch = -(-n // C)
    pad = n_ch * C - n
    if rows not in (n, n_ch * C):
        raise ValueError(f"{rows} rows for a run of {n} lines: give the "
                         f"lines, or whole chunks of {C} lines")
    y = ys[:, :W]
    if rows != n_ch * C:         # whole chunks of zero rows
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
    ss = torch.nn.functional.pad(sorts.to(torch.bool), (0, pad)).view(n_ch, C)
    chain_route, flush_route = decode_routes(W, dev)
    with trace.span("decode.chain", width=W, chunk_lines=C,
                    route=chain_route):
        trace.count("decode.chunks", n_ch)
        p_fin = pbwt_kernels.chain_decode(y.view(n_ch, C, W), ss,
                                          widen=False)
    # the samples' start order: a stable parity sort, no host sync
    start = (a[torch.argsort(a & 1, stable=True)[:W]] >> 1 if haploid
             else a)
    want_T = haploid and end
    with trace.span("decode.flush", route=flush_route, width=W,
                    chunk_lines=C, chunks=n_ch, lines=n, haps=H,
                    history=want_T):
        _, T, last = pbwt_kernels.decode_run_flush(
            p_fin, start, ss, H, n, haploid, want_T=want_T, out=out,
            line_of=line_of)
    if not end:
        return None
    if not haploid:
        return last
    r_fin, _ = pbwt_kernels.rank_chain(T, _inverse(a),
                                       max(16, _hap_bits(H)))
    return _inverse(r_fin)


def pbwt_decode_scan_mixed(ys: torch.Tensor, sorts: torch.Tensor,
                           hap_line: torch.Tensor,
                           hap_host: np.ndarray | None = None,
                           a0: torch.Tensor | None = None,
                           keep_final: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """PBWT decode of a mixed-ploidy block from the arrangement a0 (None:
    the identity, the block start) (pbwt_jax.pbwt_decode_scan_mixed;
    pbwt_kernels.decode_scan_mixed_plain has the contract), piece by piece
    as mixed_runs cuts it: a long run of one ploidy by _decode_run (the
    chunk chains, the run flush with their composition, and for a haploid
    run the rank chain), the rest by the stepping kernel from the
    arrangement the previous piece left.  The same route runs on the CPU with every
    kernel's plain version.

    hap_host: hap_line as a NumPy array, which sets the pieces without a
    device sync (required for CUDA tensors).  keep_final=False leaves out
    the end arrangement of a last piece that is a run (for a haploid run a
    rank chain) and returns None in its place.  Returns (vals uint8[Lw,
    H], a_final int64[H] or None)."""
    Lw, H = ys.shape
    dev = ys.device
    if hap_host is None:
        if dev.type != "cpu":
            raise ValueError("pbwt_decode_scan_mixed: pass the haploid flags "
                             "on the host (hap_host): reading them back "
                             "from the device would sync")
        hap_host = hap_line.numpy()
    if len(hap_host) != Lw:
        raise ValueError(f"pbwt_decode_scan_mixed: {len(hap_host)} host "
                         f"flags for {Lw} lines")
    a = torch.arange(H, device=dev) if a0 is None else a0
    vals = torch.empty((Lw, H), dtype=torch.uint8, device=dev)
    pieces = mixed_runs(hap_host, H)
    for i, (l0, l1, route) in enumerate(pieces):
        if route == "step":
            _, a = pbwt_kernels.decode_scan_mixed(
                ys[l0:l1], sorts[l0:l1], hap_line[l0:l1], a0=a,
                out=vals[l0:l1])
        else:
            a = _decode_run(ys[l0:l1], sorts[l0:l1], a, route == "haploid",
                            vals[l0:l1],
                            end=keep_final or i < len(pieces) - 1)
    return vals, a
