"""PBWT chunk chains: CUDA kernels (csrc/pbwt_chain.cu) and their plain
versions.

Port of xsqueezeit_tpu/ops/pbwt_pallas.py (chain_encode, chain_decode).
A chunk holds C <= 16 lines; its state is one value per haplotype slot in
arrangement order, and every sorting line stably partitions the slots by
the line's bit (zeros first, order kept).  Each wrapper launches a kernel
for CUDA tensors and calls the plain version for CPU tensors; there is no
fallback from one to the other.

Each chain runs on one CTA while its double-buffered row fits one CTA's
shared memory (H <= MAX_H_ENCODE / MAX_H_DECODE), and on a thread-block
cluster of 8 CTAs above that, up to H = 65,535 (at HRC width, 64,976
haplotypes, 8 CTAs ran both chains faster than 2, 3 or 4 on an H100;
PERF.md has the times).  ``cluster`` picks the route explicitly (see
:func:`cluster_size`).  ``launches`` counts kernel launches per route.

The kernels own the row by warp tiles of 512 bytes (32 lanes x 16 bytes)
and pad it to whole tiles; :func:`chain_smem_bytes` mirrors their shared
memory arithmetic (csrc/pbwt_chain.cu slots_per_cta, smem_bytes).
"""
from __future__ import annotations

import torch

from . import _build

#: Shared memory one CTA may use on an H100, less 1 KiB kept for the
#: kernels' static arrays.
_SMEM_BYTES = 227 * 1024 - 1024
#: Bytes of a warp tile: 32 lanes x one 16-byte group each.
TILE_BYTES = 32 * 16
#: Threads (hence warps) per CTA of either route.
CHAIN_WARPS = 512 // 32
#: Largest H the one-CTA kernels hold: a double-buffered row of 16-bit
#: registers (encode) or of 32-bit (slot << 16 | beta) states (decode),
#: in whole tiles.
MAX_H_ENCODE = _SMEM_BYTES // (2 * TILE_BYTES) * TILE_BYTES // 2
MAX_H_DECODE = _SMEM_BYTES // (2 * TILE_BYTES) * TILE_BYTES // 4
#: Largest H of either route: the decode state keeps the slot in 16 bits.
MAX_H = 65535
#: Most CTAs in a cluster (the portable cluster size).
MAX_CLUSTER = 8
#: Bytes per haplotype of each chain's state.
_STATE_BYTES = {"chain_encode": 2, "chain_decode": 4}

#: Kernel launches since the last reset, by kernel route.
launches = {"chain_encode": 0, "chain_decode": 0,
            "chain_encode_cluster": 0, "chain_decode_cluster": 0}


def chain_smem_bytes(name: str, H: int, K: int) -> int:
    """Dynamic shared memory per CTA of kernel `name` on K CTAs at width
    H: each CTA's share of the row, rounded up to whole tiles and double
    buffered, plus on the cluster route every warp's staging of two runs
    (a tile and 16 bytes each)."""
    state = _STATE_BYTES[name]
    tile = TILE_BYTES // state
    slots = -(-(-(-H // K)) // tile) * tile
    staging = CHAIN_WARPS * 2 * (TILE_BYTES + 16) if K > 1 else 0
    return 2 * state * slots + staging


def cluster_size(name: str, H: int, cluster: int | None = None) -> int:
    """CTAs per chain for kernel `name` at width H: 1 is the one-CTA
    route, K >= 2 a cluster of K CTAs.

    cluster=None picks 1 while the row fits one CTA and else
    MAX_CLUSTER; an int asks for that many CTAs (so a cluster can also run
    a narrow row).  Raises ValueError for a size the shared memory or the
    cluster limit refuses, and for H > 65,535."""
    if H > MAX_H:
        raise ValueError(f"{name} keeps slots in 16 bits: H <= {MAX_H} "
                         f"(got {H})")
    if cluster is None:
        K = 1 if chain_smem_bytes(name, H, 1) <= _SMEM_BYTES else MAX_CLUSTER
    else:
        K = int(cluster)
    if not 1 <= K <= MAX_CLUSTER:
        raise ValueError(f"{name}: a chain runs on 1 to {MAX_CLUSTER} CTAs "
                         f"(got {K})")
    if chain_smem_bytes(name, H, K) > _SMEM_BYTES:
        raise ValueError(f"{name} on {K} CTA(s) needs "
                         f"{chain_smem_bytes(name, H, K)} B of shared memory "
                         f"per CTA at H = {H}; {_SMEM_BYTES} B fit")
    return K


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


def chain_encode_plain(q0: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """q0: int32[n_ch, H] chunk-start registers (bit j = the haplotype's
    bit on chunk line j, slots in chunk-start arrangement order); ss:
    bool[n_ch, C] sort flags.  Returns uint8[n_ch, C, H]: line j's bits in
    the arrangement in force before line j."""
    n_ch, H = q0.shape
    C = ss.shape[1]
    q = q0.to(torch.int64)
    sorts = ss.to(torch.bool)
    ys = torch.empty((n_ch, C, H), dtype=torch.uint8, device=q0.device)
    for j in range(C):
        y = (q >> j) & 1
        ys[:, j] = y.to(torch.uint8)
        dest = _partition_dest(y, sorts[:, j])
        q = torch.empty_like(q).scatter_(1, dest, q)
    return ys


def chain_decode_plain(yc: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """yc: uint8[n_ch, C, H] bits in arrangement order; ss: bool[n_ch, C].
    Returns int64[n_ch, H]: per end-of-chunk slot, (chunk-start slot << 16)
    | beta, where bit j of beta is the element's bit on chunk line j."""
    n_ch, C, H = yc.shape
    sorts = ss.to(torch.bool)
    iota = torch.arange(H, device=yc.device)
    p = (iota << 16).expand(n_ch, H).clone()
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


def _launch(name: str, device, K: int, *args) -> None:
    """Launch `name`'s one-CTA kernel (K = 1) or its K-CTA cluster kernel
    and count the launch under its route."""
    if K == 1:
        _build.launch(device, f"xsi_{name}", *args)
        _build.count(launches, name)
    else:
        _build.launch(device, f"xsi_{name}_cluster", *args, K)
        _build.count(launches, f"{name}_cluster")


def chain_encode(q0: torch.Tensor, ss: torch.Tensor,
                 cluster: int | None = None) -> torch.Tensor:
    """Encode chunk chains (see chain_encode_plain for the contract) on
    `cluster` CTAs per chain (see cluster_size; None: chosen by H)."""
    if q0.device.type == "cpu":
        return chain_encode_plain(q0, ss)
    _check("chain_encode", q0, torch.int32, 2)
    n_ch, H = q0.shape
    K = cluster_size("chain_encode", H, cluster)
    flags = _flags("chain_encode", ss, n_ch, q0.device)
    C = flags.shape[1]
    q0 = q0.contiguous()
    y = torch.empty((n_ch, C, H), dtype=torch.uint8, device=q0.device)
    _launch("chain_encode", q0.device, K, q0.data_ptr(), flags.data_ptr(),
            y.data_ptr(), n_ch, H, C)
    return y


def chain_decode(yc: torch.Tensor, ss: torch.Tensor,
                 cluster: int | None = None) -> torch.Tensor:
    """Decode chunk chains (see chain_decode_plain for the contract) on
    `cluster` CTAs per chain (see cluster_size; None: chosen by H)."""
    if yc.device.type == "cpu":
        return chain_decode_plain(yc, ss)
    _check("chain_decode", yc, torch.uint8, 3)
    n_ch, C, H = yc.shape
    K = cluster_size("chain_decode", H, cluster)
    flags = _flags("chain_decode", ss, n_ch, yc.device)
    if flags.shape[1] != C:
        raise ValueError(f"chain_decode: {flags.shape[1]} sort flags for "
                         f"{C} lines per chunk")
    yc = yc.contiguous()
    # the kernel writes uint32 states; torch's uint32 lacks shifts, so the
    # bits land in an int32 buffer and widen to int64 here
    out = torch.empty((n_ch, H), dtype=torch.int32, device=yc.device)
    _launch("chain_decode", yc.device, K, yc.data_ptr(), flags.data_ptr(),
            out.data_ptr(), n_ch, H, C)
    return out.to(torch.int64) & 0xFFFFFFFF
