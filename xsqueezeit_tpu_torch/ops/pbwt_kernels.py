"""PBWT chunk chains and the PBWT device scans: CUDA kernels
(csrc/pbwt_chain.cu, csrc/rank_chain.cu, csrc/pbwt_scan.cu) and their
plain versions.

Port of xsqueezeit_tpu/ops/pbwt_pallas.py (chain_encode, chain_decode)
and of two XLA scans of xsqueezeit_tpu/ops/pbwt_jax.py (_rank_chain,
pbwt_decode_scan_mixed): see rank_chain, and decode_scan_mixed and
decode_run_flush below (the mixed scan's stepping kernel and the run
flush; ops/pbwt_torch.py composes them: pbwt_decode_chunked is
chain_decode and the run flush, pbwt_decode_scan_mixed adds the stepping
kernel for short runs).
A chunk holds C <= 16 lines; its state is one value per haplotype slot in
arrangement order, and every sorting line stably partitions the slots by
the line's bit (zeros first, order kept).  Each wrapper launches a kernel
for CUDA tensors and calls the plain version for CPU tensors; there is no
fallback from one to the other.

Each chain runs on one CTA while its double-buffered row fits one CTA's
shared memory (H <= MAX_H_ENCODE / MAX_H_DECODE), and on a thread-block
cluster above that, up to the format's widest panel (MAX_RANK_H =
491,505).  The encode, whose state is a 16-bit register, keeps the row in
the cluster's shared memory: 8 CTAs (at HRC width, 64,976 haplotypes, 8
ran faster than 2, 3 or 4 on an H100; PERF.md has the times), 16 where 8
do not hold it.  The decode, whose 4-byte state (chunk-start slot <<
shift) | beta keeps shift = 16 up to 65,536 slots and shift = C = 32 -
ceil(log2 H) lines a chunk above (decode_chunk), runs on 16 CTAs with
both rows in device memory (chain_decode_rows in ``launches``): at HRC
and TOPMed widths that ran faster than the cluster's shared memory.  Each
bound follows from chain_max_h.  ``cluster`` picks the route explicitly
(see :func:`cluster_size`).  ``launches`` counts kernel launches per
route (:func:`chain_route`).  With ``parity=True`` the encode carries
each haplotype's slot parity in bit 15 of its register (chunks of
PARITY_CHUNK = 15 lines) and emits it beside each line's bit: the
mixed-ploidy encode's route, with the contract of the JAX package's
pbwt_jax.pbwt_encode_scan_parity (a row sort of packed keys there).

The kernels own the row by warp tiles of 512 bytes (32 lanes x 16 bytes)
and pad it to whole tiles; :func:`chain_smem_bytes` mirrors their shared
memory arithmetic (csrc/pbwt_chain.cu slots_per_cta, smem_bytes).
"""
from __future__ import annotations

import torch

from . import _build
from ..utils import trace

#: Shared memory one CTA may use on an H100, less 1 KiB kept for the
#: kernels' static arrays.
_SMEM_BYTES = 227 * 1024 - 1024
#: Bytes of a warp tile: 32 lanes x one 16-byte group each.
TILE_BYTES = 32 * 16
#: Threads (hence warps) per CTA of either route.
CHAIN_WARPS = 512 // 32
#: The widest row whose slots fit 16 bits: the narrow decode state (slot
#: << 16 | beta), the run flush's one-CTA route, the rank chain's 2-byte
#: dense ranks.
SLOT16_H = 65535
#: The format's widest panel (32,767 WAH words of 15 haplotypes a line):
#: the rank chain and the encode chain take every width up to it.
MAX_RANK_H = 491505
#: Cluster sizes: 8 is portable; 16, the most an H100 takes, needs the
#: kernels' non-portable attribute.
PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16
#: Bytes per haplotype of each chain's state.
_STATE_BYTES = {"chain_encode": 2, "chain_decode": 4}
#: CTAs a chunk of the run flush above SLOT16_H slots.
FLUSH_CLUSTER = 8
#: Lines a chunk of the encode chain with the parity payload: bit 15 of
#: each 16-bit register holds the haplotype's slot parity.
PARITY_CHUNK = 15

#: Kernel launches since the last reset, by kernel route.
launches = {"chain_encode": 0, "chain_decode": 0,
            "chain_encode_cluster": 0, "chain_decode_rows": 0,
            "chain_encode_parity": 0, "chain_encode_parity_cluster": 0,
            "rank_chain": 0, "decode_scan_mixed": 0, "decode_run_flush": 0,
            "decode_run_flush_cluster": 0}


#: Tiles a CTA owns on the decode's cluster route, rows in device memory
#: (csrc/pbwt_chain.cu MAX_TILES_ROWS): 65,536 slots.
MAX_TILES_ROWS = 512


def _rows_in_device_memory(name: str, K: int) -> bool:
    """The decode on a cluster keeps both rows in device memory."""
    return name == "chain_decode" and K > 1


def _staging_bytes(K: int) -> int:
    """Every warp's staging of two runs (a tile and 16 bytes each) on the
    encode's cluster route."""
    return CHAIN_WARPS * 2 * (TILE_BYTES + 16) if K > 1 else 0


def chain_slots(name: str, H: int, K: int) -> int:
    """Slots a CTA of kernel `name` owns on K CTAs at width H: ceil(H / K)
    in whole tiles (256 u16 registers or 128 u32 states)."""
    tile = TILE_BYTES // _STATE_BYTES[name]
    return -(-(-(-H // K)) // tile) * tile


def chain_smem_bytes(name: str, H: int, K: int) -> int:
    """Dynamic shared memory per CTA of kernel `name` on K CTAs at width
    H: each CTA's slots double buffered, plus on the encode's cluster
    route every warp's staging; 0 for the decode on a cluster, whose rows
    are in device memory."""
    if _rows_in_device_memory(name, K):
        return 0
    state = _STATE_BYTES[name]
    return 2 * state * chain_slots(name, H, K) + _staging_bytes(K)


def chain_max_h(name: str, K: int) -> int:
    """The widest row kernel `name` holds on K CTAs: K times the whole
    tiles a CTA owns, which are those of its shared memory, double
    buffered, after the staging (MAX_TILES_ROWS for the decode on a
    cluster)."""
    tile = TILE_BYTES // _STATE_BYTES[name]
    if _rows_in_device_memory(name, K):
        return MAX_TILES_ROWS * tile * K
    state = _STATE_BYTES[name]
    return (_SMEM_BYTES - _staging_bytes(K)) // (2 * state) // tile * tile * K


#: The widest rows of the one-CTA routes (57,856 encode, 28,928 decode).
MAX_H_ENCODE = chain_max_h("chain_encode", 1)
MAX_H_DECODE = chain_max_h("chain_decode", 1)


def cluster_size(name: str, H: int, cluster: int | None = None) -> int:
    """CTAs per chain for kernel `name` at width H: 1 is the one-CTA
    route, K >= 2 a cluster of K CTAs.

    cluster=None picks one CTA while its shared memory holds the row, else
    for the encode the first of 8 and 16 CTAs whose shared memory does,
    for the decode 16 CTAs (rows in device memory); an int asks for that
    many CTAs (so a cluster can also run a narrow row).  Raises ValueError
    for a size the shared memory, the cluster limit or MAX_TILES_ROWS
    refuses, and for H > MAX_RANK_H."""
    if H > MAX_RANK_H:
        raise ValueError(f"{name} takes at most {MAX_RANK_H} haplotypes, "
                         f"the format's widest panel (got {H})")
    if cluster is None:
        sizes = ((1, PORTABLE_CLUSTER, MAX_CLUSTER) if name == "chain_encode"
                 else (1, MAX_CLUSTER))
        K = next(k for k in sizes
                 if H <= chain_max_h(name, k) or k == MAX_CLUSTER)
    else:
        K = int(cluster)
    if not 1 <= K <= MAX_CLUSTER:
        raise ValueError(f"{name}: a chain runs on 1 to {MAX_CLUSTER} CTAs "
                         f"(got {K})")
    if H > chain_max_h(name, K):
        where = ("device memory" if _rows_in_device_memory(name, K)
                 else "shared memory")
        raise ValueError(f"{name} on {K} CTA(s) holds at most "
                         f"{chain_max_h(name, K)} haplotypes in {where} "
                         f"(got H = {H})")
    return K


def chain_route(name: str, K: int) -> str:
    """The ``launches`` key of kernel `name` on K CTAs."""
    if K == 1:
        return name
    return "chain_decode_rows" if name == "chain_decode" else f"{name}_cluster"


def _slot_bits(W: int) -> int:
    """Bits of a slot index below W (at least 1)."""
    return max(int(W - 1).bit_length(), 1)


def decode_chunk(W: int) -> int:
    """Lines a chunk of the decode chain at W slots, which is also its
    state's shift: 16 while the slots fit 16 bits (W <= 65,536), else C =
    32 - ceil(log2 W), so that (slot << C) | beta fills the 32 bits (15 at
    65,600, 14 at 194,512, 13 at 491,505)."""
    return min(16, 32 - _slot_bits(W))


def _check_chunk(name: str, W: int, C: int) -> None:
    """A chunk's beta must fit beside the slot: C <= decode_chunk(W)."""
    if C > decode_chunk(W):
        raise ValueError(f"{name}: a chunk of a row of {W} slots holds at "
                         f"most {decode_chunk(W)} lines (got {C})")


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of each row permutation of the last axis."""
    iota = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, iota)


def _compose_prefix(o_tot: torch.Tensor) -> torch.Tensor:
    """Arrangement at the end of every chunk: inc[t] = inc[t-1][o_tot[t]]
    (inc[-1] = identity), as a log-step doubling scan of gathers."""
    inc = o_tot.clone()
    d = 1
    while d < inc.shape[0]:
        inc[d:] = torch.gather(inc[:-d], 1, inc[d:])
        d <<= 1
    return inc


def _partition_dest(y: torch.Tensor, sorts: torch.Tensor) -> torch.Tensor:
    """Destination slot of every element under a stable partition by y
    (rows of [n_ch, H]); identity on rows whose sort flag is off."""
    H = y.shape[1]
    iota = torch.arange(H, device=y.device)
    ones_incl = torch.cumsum(y, 1)
    ones_before = ones_incl - y
    n_zeros = H - ones_incl[:, -1:]
    dest = torch.where(y == 0, iota - ones_before, n_zeros + ones_before)
    return torch.where(sorts[:, None], dest, iota)


def chain_encode_plain(q0: torch.Tensor, ss: torch.Tensor,
                       parity: bool = False) -> torch.Tensor:
    """q0: int32[n_ch, H] chunk-start registers (bit j = the haplotype's
    bit on chunk line j, slots in chunk-start arrangement order); ss:
    bool[n_ch, C] sort flags.  Returns uint8[n_ch, C, H]: line j's bits in
    the arrangement in force before line j.  With `parity` (C <=
    PARITY_CHUNK) bit 15 of each register travels with it, and each output
    byte also holds that bit, the slot's parity, at bit 1."""
    n_ch, H = q0.shape
    C = ss.shape[1]
    q = q0.to(torch.int64)
    sorts = ss.to(torch.bool)
    ys = torch.empty((n_ch, C, H), dtype=torch.uint8, device=q0.device)
    for j in range(C):
        y = (q >> j) & 1
        ys[:, j] = (y | (((q >> 15) & 1) << 1) if parity else y).to(
            torch.uint8)
        dest = _partition_dest(y, sorts[:, j])
        q = torch.empty_like(q).scatter_(1, dest, q)
    return ys


def chain_decode_plain(yc: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """yc: uint8[n_ch, C, H] bits in arrangement order; ss: bool[n_ch, C].
    Returns int64[n_ch, H]: per end-of-chunk slot, (chunk-start slot <<
    decode_chunk(H)) | beta, where bit j of beta is the element's bit on
    chunk line j (below 2^32; the top bit may be set)."""
    n_ch, C, H = yc.shape
    sorts = ss.to(torch.bool)
    iota = torch.arange(H, device=yc.device)
    p = (iota << decode_chunk(H)).expand(n_ch, H).clone()
    for j in range(C):
        y = yc[:, j].to(torch.int64)
        p = p | (y << j)
        dest = _partition_dest(y, sorts[:, j])
        p = torch.empty_like(p).scatter_(1, dest, p)
    return p


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"{name}: expected {dim}-D {dtype}, got "
                         f"{t.dim()}-D {t.dtype}")


def _flags(name: str, ss: torch.Tensor, n_ch: int,
           device: torch.device) -> torch.Tensor:
    if ss.dtype not in (torch.bool, torch.uint8) or ss.dim() != 2 \
            or ss.shape[0] != n_ch or not 1 <= ss.shape[1] <= 16 \
            or ss.device != device:
        raise ValueError(f"{name}: ss must be bool[{n_ch}, C <= 16] on "
                         f"{device}, got {ss.dtype} {tuple(ss.shape)} on "
                         f"{ss.device}")
    return ss.contiguous().view(torch.uint8)


def chain_encode(q0: torch.Tensor, ss: torch.Tensor,
                 cluster: int | None = None, parity: bool = False
                 ) -> torch.Tensor:
    """Encode chunk chains (see chain_encode_plain for the contract) on
    `cluster` CTAs per chain (see cluster_size; None: chosen by H), with
    the parity payload if `parity` (counted as chain_encode_parity /
    chain_encode_parity_cluster).  Raises ValueError for parity with more
    than PARITY_CHUNK lines a chunk."""
    if parity and ss.dim() == 2 and ss.shape[1] > PARITY_CHUNK:
        raise ValueError(f"chain_encode: with the parity payload a chunk "
                         f"holds at most {PARITY_CHUNK} lines (got "
                         f"{ss.shape[1]})")
    if q0.device.type == "cpu":
        return chain_encode_plain(q0, ss, parity)
    _check("chain_encode", q0, torch.int32, 2)
    n_ch, H = q0.shape
    K = cluster_size("chain_encode", H, cluster)
    flags = _flags("chain_encode", ss, n_ch, q0.device)
    C = flags.shape[1]
    q0 = q0.contiguous()
    y = torch.empty((n_ch, C, H), dtype=torch.uint8, device=q0.device)
    args = (q0.data_ptr(), flags.data_ptr(), y.data_ptr(), n_ch, H, C)
    name = "chain_encode_parity" if parity else "chain_encode"
    if K == 1:
        _build.launch(q0.device, f"xsi_{name}", *args)
    else:
        _build.launch(q0.device, f"xsi_{name}_cluster", *args, K)
    trace.count(chain_route(name, K), into=launches)
    return y


def _u32_bits(p: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 as int32 holding the same 32 bits."""
    return (p - ((p & 0x80000000) << 1)).to(torch.int32)


def chain_decode(yc: torch.Tensor, ss: torch.Tensor,
                 cluster: int | None = None, widen: bool = True
                 ) -> torch.Tensor:
    """Decode chunk chains (see chain_decode_plain for the contract) on
    `cluster` CTAs per chain (see cluster_size; None: chosen by H): one
    CTA holds both rows in its shared memory, a cluster of K keeps them in
    device memory (a scratch of 2 K chain_slots states a chunk, allocated
    here).  widen=False returns the states as the kernel writes them:
    int32 holding each uint32 state's bits (what decode_run_flush reads).
    Raises ValueError for more lines a chunk than decode_chunk(H)."""
    if yc.dim() == 3:
        _check_chunk("chain_decode", yc.shape[2], yc.shape[1])
    if yc.device.type == "cpu":
        p = chain_decode_plain(yc, ss)
        return p if widen else _u32_bits(p)
    _check("chain_decode", yc, torch.uint8, 3)
    n_ch, C, H = yc.shape
    K = cluster_size("chain_decode", H, cluster)
    flags = _flags("chain_decode", ss, n_ch, yc.device)
    if flags.shape[1] != C:
        raise ValueError(f"chain_decode: {flags.shape[1]} sort flags for "
                         f"{C} lines per chunk")
    yc = yc.contiguous()
    # the kernel writes uint32 states; torch's uint32 lacks shifts, so the
    # bits land in an int32 buffer and widen to int64 here if asked
    out = torch.empty((n_ch, H), dtype=torch.int32, device=yc.device)
    shift = decode_chunk(H)
    if K == 1:
        _build.launch(yc.device, "xsi_chain_decode", yc.data_ptr(),
                      flags.data_ptr(), out.data_ptr(), n_ch, H, C, shift)
    else:
        scratch = torch.empty(n_ch * 2 * K * chain_slots("chain_decode", H, K),
                              dtype=torch.int32, device=yc.device)
        _build.launch(yc.device, "xsi_chain_decode_rows", yc.data_ptr(),
                      flags.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                      n_ch, H, C, shift, K)
    trace.count(chain_route("chain_decode", K), into=launches)
    return out.to(torch.int64) & 0xFFFFFFFF if widen else out


def rank_chain_plain(T: torch.Tensor, r0: torch.Tensor, r_bits: int = 16
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-start rank chain: r_{t+1} = rank of each haplotype by
    (T_t, r_t).

    T: int32/int64[n_ch, H] per-chunk history totals (latest sorting bit
    highest), below 2^31; r0: int64[H] ranks below 2^r_bits, with T <<
    r_bits inside int64.  Returns (r_final int64[H], r_starts int64[n_ch,
    H]).  One chunk per step: the key (T_t << r_bits) | r_t is unique per
    haplotype (ranks are), so one sort per chunk orders it.
    """
    n_ch, H = T.shape
    r = r0
    r_starts = torch.empty((n_ch, H), dtype=torch.int64, device=T.device)
    for t in range(n_ch):
        r_starts[t] = r
        order = torch.argsort((T[t].to(torch.int64) << r_bits) | r)
        r = _inverse(order)
    return r, r_starts


def _dense_rank(keys: torch.Tensor) -> torch.Tensor:
    """Dense rank of each row's keys (equal keys equal ranks, order kept):
    one batched sort and one scan."""
    s, order = torch.sort(keys, dim=1)
    new = torch.zeros_like(s)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return torch.empty_like(s).scatter_(1, order, torch.cumsum(new, 1))


def rank_chain_levels_plain(T: torch.Tensor, r0: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank chain (rank_chain_plain's contract; r0 a permutation of
    0..H-1) as csrc/rank_chain.cu computes it: a log-depth scan of dense
    ranks.

    P_t, the dense rank over h of the tuple (T_{t-1}[h], ..., T_0[h])
    (P_0 = 0), gives r_t = the rank of h by (P_t[h], r0[h]): the radix
    identity.  Level 0 sets W_t = the dense rank of T_{t-1} (t = 1..n_ch);
    the level of stride d = 1, 2, 4, ... sets W_t = the dense rank of the
    pair (W_t, W_{t-d}) for t > d (its window doubles; rows t <= d are
    complete); once d >= n_ch, W_t = P_t, and a final level ranks (P_t,
    r0).  Each level is one batched sort and one scan over the rows."""
    n_ch, H = T.shape
    b = max(int(H - 1).bit_length(), 1)
    W = _dense_rank(T.to(torch.int64))           # row t - 1 holds W_t
    d = 1
    while d < n_ch:
        pair = (W[d:] << b) | W[:-d]
        W = torch.cat([W[:d], _dense_rank(pair)])
        d <<= 1
    P = torch.cat([torch.zeros((1, H), dtype=torch.int64, device=T.device),
                   W])
    r = _inverse(torch.argsort((P << b) | r0, dim=1))
    return r[n_ch], r[:n_ch]


#: Widest row the rank chain sorts in one CTA's shared memory (16-bit
#: dense ranks up to SLOT16_H, 32-bit above, up to MAX_RANK_H).
RANK_SMEM_H = 16384
#: The device route's digit radix and keys per tile (csrc/rank_chain.cu).
RANK_RADIX = 256
RANK_TILE = 4096


def rank_route(H: int) -> tuple[str, int]:
    """The rank chain's route at width H: "shared" (a row a CTA in shared
    memory) up to RANK_SMEM_H, else "device" (rows through device memory,
    a CTA a tile); and the bytes of a dense rank (2 up to 65,535, else
    4).  Raises ValueError outside 1 <= H <= MAX_RANK_H."""
    if not 1 <= H <= MAX_RANK_H:
        raise ValueError(f"rank_chain takes 1 <= H <= {MAX_RANK_H} "
                         f"haplotypes (got {H})")
    return ("shared" if H <= RANK_SMEM_H else "device",
            2 if H <= SLOT16_H else 4)


def rank_scratch_bytes(n_ch: int, H: int) -> int:
    """Device scratch of the rank chain (mirrors csrc/rank_chain.cu
    Scratch): the dense ranks, distinct counts and rows' modes, double
    buffered; on the device route also the keys (twice the rank's bytes)
    and payloads, double buffered, the rows' OR / AND and the digit and
    flag counts.  Each array starts 256-byte aligned."""
    route, rb = rank_route(H)

    def a(n):
        return -(-n // 256) * 256
    nh = n_ch * H
    n = 2 * a(nh * rb) + 4 * a(4 * n_ch)
    if route == "device":
        tiles = -(-H // RANK_TILE)
        n += (a(2 * nh * 2 * rb) + a(2 * nh * rb) + 2 * a(8 * n_ch)
              + a(4 * n_ch * RANK_RADIX * tiles) + a(4 * n_ch * tiles))
    return n


def rank_chain(T: torch.Tensor, r0: torch.Tensor, r_bits: int = 16
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank chain (see rank_chain_plain for the contract) as
    csrc/rank_chain.cu's log-depth scan of row sorts (rank_chain_levels_plain
    states it), for every 1 <= H <= MAX_RANK_H, on the route rank_route(H)
    picks; r0 must be a permutation of 0..H-1 and T below 2^31.  The
    kernels read T as int32: an int64 T is narrowed here first.  CPU
    tensors take rank_chain_plain."""
    if T.dtype not in (torch.int32, torch.int64) or T.dim() != 2:
        raise ValueError(f"rank_chain: expected 2-D int32 or int64 T, got "
                         f"{T.dim()}-D {T.dtype}")
    n_ch, H = T.shape
    if r0.dtype != torch.int64 or tuple(r0.shape) != (H,) \
            or r0.device != T.device:
        raise ValueError(f"rank_chain: r0 must be int64[{H}] on {T.device}, "
                         f"got {r0.dtype} {tuple(r0.shape)} on {r0.device}")
    if T.device.type == "cpu":
        return rank_chain_plain(T, r0, r_bits)
    if T.device.type != "cuda":
        raise ValueError(f"rank_chain: unsupported device {T.device}")
    scratch = torch.empty(rank_scratch_bytes(n_ch, H), dtype=torch.uint8,
                          device=T.device)
    T32 = T.to(torch.int32).contiguous()
    r0 = r0.contiguous()
    r_starts = torch.empty((n_ch, H), dtype=torch.int64, device=T.device)
    r_fin = torch.empty(H, dtype=torch.int64, device=T.device)
    _build.launch(T.device, "xsi_rank_chain", T32.data_ptr(), r0.data_ptr(),
                  r_starts.data_ptr(), r_fin.data_ptr(), scratch.data_ptr(),
                  scratch.numel(), n_ch, H)
    trace.count("rank_chain", into=launches)
    return r_fin, r_starts


def decode_scan_mixed_plain(ys: torch.Tensor, sorts: torch.Tensor,
                            hap_line: torch.Tensor,
                            a0: torch.Tensor | None = None,
                            out: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """PBWT decode of a mixed-ploidy block, one step per line, from the
    arrangement a0 (int64[H]; None: the identity, the block start)
    (pbwt_jax.pbwt_decode_scan_mixed; with no haploid line it is
    pbwt_jax.pbwt_decode_scan).

    ys: uint8[L, H] bits in arrangement order; a haploid line holds only
    its N = ceil(H / 2) even-parity bits, front-packed (the on-disk form).
    Its slot-duplicated bits are rebuilt first: position i holds sample
    a[i] >> 1, whose even slot sits at position inv[a[i] & ~1], whose rank
    among the even-parity positions indexes the stored bits.  Then the
    bits land in natural order (vals[a[i]] = y[i]) and a sorting line
    stably partitions the arrangement by them.  sorts, hap_line: bool[L].
    Returns (vals uint8[L, H] natural-order bits, haploid lines
    slot-duplicated, written into `out` if given; a_final int64[H]).
    """
    L, H = ys.shape
    dev = ys.device
    iota = torch.arange(H, device=dev)
    a = iota.clone() if a0 is None else a0.clone()
    vals = (torch.empty((L, H), dtype=torch.uint8, device=dev)
            if out is None else out)
    always = torch.ones(1, dtype=torch.bool, device=dev)
    # the flags decide the host-side branches: one transfer, no syncs
    for l, (sort, hap) in enumerate(zip(sorts.tolist(), hap_line.tolist())):
        y = ys[l].to(torch.int64)
        if hap:
            even = 1 - (a & 1)
            rank_even = torch.cumsum(even, 0) - even
            inv = torch.empty_like(a).scatter_(0, a, iota)
            y = y[rank_even[inv[a & ~1]]]
        vals[l].scatter_(0, a, y.to(torch.uint8))
        if sort:
            dest = _partition_dest(y[None], always)[0]
            a = torch.empty_like(a).scatter_(0, dest, a)
    return vals, a


def mixed_smem_bytes(H: int) -> int:
    """Shared memory of the mixed scan's shared route at width H (mirrors
    csrc/pbwt_scan.cu mixed_smem_bytes): the arrangement, its double
    buffer and the even ranks as int32, the stored line, y and the line in
    natural order as bytes."""
    return 4 * (2 * H + (H + 1) // 2) + 3 * H


def mixed_scratch_bytes(H: int) -> int:
    """Device-memory scratch of the mixed scan's wide route: its int32
    arrays and y (the line is read and written in place)."""
    return 4 * (2 * H + (H + 1) // 2) + H


def _check_out(name: str, out: torch.Tensor | None, shape: tuple,
               device: torch.device, min_rows: bool = False) -> None:
    """out None, or a contiguous uint8 plane of `shape` on `device` (with
    min_rows, of at least shape[0] rows)."""
    if out is not None and (out.dtype != torch.uint8 or out.dim() != 2
                            or out.shape[1] != shape[1]
                            or (out.shape[0] < shape[0] if min_rows
                                else out.shape[0] != shape[0])
                            or out.device != device
                            or not out.is_contiguous()):
        rows = f"[>= {shape[0]}, {shape[1]}]" if min_rows else list(shape)
        raise ValueError(f"{name}: out must be a contiguous uint8{rows}"
                         f" on {device}, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")


def decode_scan_mixed(ys: torch.Tensor, sorts: torch.Tensor,
                      hap_line: torch.Tensor,
                      a0: torch.Tensor | None = None,
                      out: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixed-ploidy decode scan line by line (see decode_scan_mixed_plain
    for the contract) in one launch of csrc/pbwt_scan.cu's stepping kernel
    decode_scan_mixed_kernel, one CTA over all lines, flags read on the
    device (no host sync).  Its state lives in shared memory while
    mixed_smem_bytes(H) fits one CTA, else in a device scratch allocated
    here (any H)."""
    if ys.dtype != torch.uint8 or ys.dim() != 2:
        raise ValueError(f"decode_scan_mixed: expected 2-D uint8 ys, got "
                         f"{ys.dim()}-D {ys.dtype}")
    Lw, H = ys.shape
    flags = []
    for name, f in (("sorts", sorts), ("hap_line", hap_line)):
        if f.dtype not in (torch.bool, torch.uint8) or f.dim() != 1 \
                or f.shape[0] != Lw or f.device != ys.device:
            raise ValueError(f"decode_scan_mixed: {name} must be bool[{Lw}] "
                             f"on {ys.device}, got {f.dtype} "
                             f"{tuple(f.shape)} on {f.device}")
        flags.append(f.contiguous().view(torch.uint8))
    if a0 is not None and (a0.dtype != torch.int64 or tuple(a0.shape) != (H,)
                           or a0.device != ys.device):
        raise ValueError(f"decode_scan_mixed: a0 must be int64[{H}] on "
                         f"{ys.device}, got {a0.dtype} {tuple(a0.shape)} on "
                         f"{a0.device}")
    _check_out("decode_scan_mixed", out, (Lw, H), ys.device)
    if ys.device.type == "cpu":
        return decode_scan_mixed_plain(ys, sorts, hap_line, a0, out)
    _check("decode_scan_mixed", ys, torch.uint8, 2)
    if H < 1:
        raise ValueError("decode_scan_mixed: H must be >= 1")
    ys = ys.contiguous()
    vals = (torch.empty((Lw, H), dtype=torch.uint8, device=ys.device)
            if out is None else out)
    a_fin = torch.empty(H, dtype=torch.int64, device=ys.device)
    if a0 is not None:
        a0 = a0.contiguous()
    scratch = None
    if mixed_smem_bytes(H) > _SMEM_BYTES:
        scratch = torch.empty(mixed_scratch_bytes(H), dtype=torch.uint8,
                              device=ys.device)
    _build.launch(ys.device, "xsi_decode_scan_mixed", ys.data_ptr(),
                  flags[0].data_ptr(), flags[1].data_ptr(), vals.data_ptr(),
                  a_fin.data_ptr(), None if a0 is None else a0.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), Lw, H)
    trace.count("decode_scan_mixed", into=launches)
    return vals, a_fin


def decode_run_flush_plain(p_fin: torch.Tensor, start: torch.Tensor,
                           ss: torch.Tensor, H: int, n: int, haploid: bool,
                           want_T: bool = False,
                           out: torch.Tensor | None = None,
                           line_of: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor | None,
                                      torch.Tensor]:
    """The run flush of the mixed scan's run route: a run's chunk-chain
    states back to natural-order rows.

    p_fin: int32[n_ch, W] per end-of-chunk slot the uint32 state's bits,
    (chunk-start slot << decode_chunk(W)) | beta (chain_decode with
    widen=False); start: int64[W] the haplotype (diploid run, W = H) or
    the sample (haploid run, W = ceil(H / 2)) at each run-start
    position; ss: bool[n_ch, C] the sort flags; n: the run's lines,
    (n_ch - 1) C < n <= n_ch C.  The chunks compose (_compose_prefix) into
    the run-start position at each end slot.  Returns (rows uint8[n, H],
    written into `out` if given: row C t + k holds bit k of beta at each
    haplotype, a haploid sample's bit at both of its slots; with a line map
    line_of (int32 or int64[n]) `out` is a uint8[L, H] plane, L >= n, row
    k is stored at out[line_of[k]] and out is returned; T int32[n_ch,
    H] if want_T, else None: each haplotype's bits on its chunk's sorting
    lines, latest highest, the rank chain's histories; last int64[W]: the
    haplotype (sample) at each end slot of the run, a diploid run's end
    arrangement)."""
    n_ch, W = p_fin.shape
    C = ss.shape[1]
    dev = p_fin.device
    p = p_fin.to(torch.int64) & 0xFFFFFFFF
    shift = decode_chunk(W)
    at = start[_compose_prefix(p >> shift)]    # haplotype per end slot
    # beta in natural order: sample (haploid) or haplotype per column
    X = torch.empty_like(p).scatter_(1, at, p & ((1 << shift) - 1))
    if haploid:
        X = X.repeat_interleave(2, dim=1)[:, :H]
    full = torch.empty((n_ch, C, H), dtype=torch.uint8, device=dev)
    for k in range(C):       # one line at a time: temporaries [n_ch, H]
        full[:, k] = (X >> k) & 1
    if line_of is not None:
        rows = out.index_copy_(0, line_of.to(torch.int64),
                               full.reshape(n_ch * C, H)[:n])
    else:
        rows = torch.empty((n, H), dtype=torch.uint8, device=dev) \
            if out is None else out
        rows.copy_(full.reshape(n_ch * C, H)[:n])
    T = None
    if want_T:
        ssi = ss.to(torch.int64)
        sh = torch.cumsum(ssi, 1) - ssi
        T = torch.zeros((n_ch, H), dtype=torch.int64, device=dev)
        for k in range(C):
            T |= (((X >> k) & 1) << sh[:, k:k + 1]) * ssi[:, k:k + 1]
        T = T.to(torch.int32)
    return rows, T, at[-1]


def flush_cluster(W: int) -> int:
    """CTAs a chunk of the run flush at W slots, as csrc/pbwt_scan.cu
    chooses them (FLUSH_ONE_CTA_W), mirrored here to count the launch: 1
    up to SLOT16_H slots, where the one-CTA route stood before the wide
    state (its 2 B a slot would fit about 115,000), else FLUSH_CLUSTER."""
    return 1 if W <= SLOT16_H else FLUSH_CLUSTER


def decode_run_flush(p_fin: torch.Tensor, start: torch.Tensor,
                     ss: torch.Tensor, H: int, n: int, haploid: bool,
                     want_T: bool = False, out: torch.Tensor | None = None,
                     line_of: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor | None,
                                torch.Tensor]:
    """The run flush (see decode_run_flush_plain for the contract) in one
    call of csrc/pbwt_scan.cu's xsi_decode_run_flush: the composition, one
    launch a level over all chunks (through a scratch of two int32 [n_ch,
    W] buffers allocated here), then the flush: decode_run_flush_kernel, a
    CTA a chunk, beta scattered to natural order in its shared memory (W
    <= 65,535), or above that decode_run_flush_cluster_kernel, a cluster
    of FLUSH_CLUSTER CTAs a chunk, each holding W / 8 columns (counted as
    decode_run_flush_cluster).  With a line map (line_of, int32 or
    int64[n], each a row of `out`, which it then needs) each row is stored
    at its own line of `out`, still H contiguous bytes; the map's values
    are not read back, so they must lie below out's rows."""
    name = "decode_run_flush"
    if p_fin.dim() != 2 or p_fin.dtype != torch.int32:
        raise ValueError(f"{name}: p_fin must be int32[n_ch, W], got "
                         f"{p_fin.dtype} {tuple(p_fin.shape)}")
    n_ch, W = p_fin.shape
    if W != ((H + 1) // 2 if haploid else H) or not 1 <= W <= MAX_RANK_H:
        raise ValueError(f"{name}: W = {W} slots for a "
                         f"{'haploid' if haploid else 'diploid'} run of "
                         f"H = {H} (at most {MAX_RANK_H})")
    if start.dtype != torch.int64 or tuple(start.shape) != (W,) \
            or start.device != p_fin.device:
        raise ValueError(f"{name}: start must be int64[{W}] on "
                         f"{p_fin.device}, got {start.dtype} "
                         f"{tuple(start.shape)} on {start.device}")
    flags = _flags(name, ss, n_ch, p_fin.device)
    C = flags.shape[1]
    if not (n_ch - 1) * C < n <= n_ch * C:
        raise ValueError(f"{name}: {n} lines in {n_ch} chunks of {C}")
    _check_chunk(name, W, C)
    if line_of is not None:
        if out is None or line_of.dtype not in (torch.int32, torch.int64) \
                or tuple(line_of.shape) != (n,) \
                or line_of.device != p_fin.device:
            raise ValueError(f"{name}: line_of must be int32 or int64[{n}] "
                             f"on {p_fin.device}, with out, got "
                             f"{line_of.dtype} {tuple(line_of.shape)} on "
                             f"{line_of.device}")
        line_of = line_of.to(torch.int64).contiguous()
    _check_out(name, out, (n, H), p_fin.device, min_rows=line_of is not None)
    if p_fin.device.type == "cpu":
        return decode_run_flush_plain(p_fin, start, ss, H, n, haploid,
                                      want_T, out, line_of)
    _check(name, p_fin, torch.int32, 2)
    dev = p_fin.device
    p_fin, start = p_fin.contiguous(), start.contiguous()
    rows = (torch.empty((n, H), dtype=torch.uint8, device=dev)
            if out is None else out)
    T = (torch.empty((n_ch, H), dtype=torch.int32, device=dev)
         if want_T else None)
    last = torch.empty(W, dtype=torch.int64, device=dev)
    scratch = (torch.empty(2 * n_ch * W, dtype=torch.int32, device=dev)
               if n_ch > 1 else None)
    _build.launch(dev, "xsi_decode_run_flush", p_fin.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  start.data_ptr(), flags.data_ptr(), rows.data_ptr(),
                  None if line_of is None else line_of.data_ptr(),
                  None if T is None else T.data_ptr(), last.data_ptr(),
                  n_ch, C, W, H, n, int(haploid), decode_chunk(W))
    trace.count(name if flush_cluster(W) == 1 else f"{name}_cluster",
                into=launches)
    return rows, T, last
