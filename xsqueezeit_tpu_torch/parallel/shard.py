"""Several devices in one process: data parallelism over the block axis.

The port's counterpart of xsqueezeit_tpu/parallel/shard.py.  Variant
blocks are independent (the PBWT arrangement re-seeds to identity at
every block boundary), so a batch of blocks spreads over a pool of
devices: block i runs on devices[i % n], one worker thread per device,
each block through the same single-device codec (TorchBlockEncoder's
prepare / encode_prepared / assemble, TorchBlockDecoder's decode_all).
Payloads and bits are therefore the same bytes whatever the pool, and the
container written from them is byte-identical to the one-device file.

The JAX package's shard_map over padded block batches (with a psum of
the batch's compressed bytes) is an XLA form: here each block keeps its
own shapes, nothing is padded, and the byte total is a host sum.  The
pool is a list of torch devices, so a test passes N CPU devices and a
card may appear twice ([cuda:0, cuda:0]: two threads sharing one card,
their kernels serialised on its default stream, their host work side by
side).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch


def local_mesh(max_devices: int | None = None,
               kind: str = "cuda") -> list[torch.device] | None:
    """This process's devices of `kind` as a block pool, or None when
    there is only one (the single-device path).  "cuda" counts
    torch.cuda.device_count() cards; any other kind is one device.
    XSI_LOCAL_DEVICES caps the count (XSI_LOCAL_DEVICES=1 disables the
    pool)."""
    if kind == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(kind)]
    cap = os.environ.get("XSI_LOCAL_DEVICES")
    if cap is not None:
        devs = devs[:max(int(cap), 1)]
    if max_devices is not None:
        devs = devs[:max_devices]
    if len(devs) <= 1:
        return None
    return devs


def device_pool(devices, device: torch.device) -> list[torch.device]:
    """The block pool of a run: `devices` when given, else every local
    device of `device`'s kind (local_mesh), else [device] alone.  Nothing
    here probes whether a device works: a pool that cannot run fails at
    its first block."""
    if devices is None:
        return local_mesh(kind=device.type) or [device]
    if not devices:
        raise ValueError("an empty device pool")
    return [torch.device(d) for d in devices]


def map_blocks(fn, items: list, devices: list) -> list:
    """[fn(items[i], devices[i % n])] with one worker thread per device,
    each taking its blocks in order; results in item order.  The first
    exception raised is raised here, after every worker has ended.  A
    pool of one device runs fn in the calling thread."""
    n = len(devices)
    if n == 1:
        return [fn(item, devices[0]) for item in items]

    def worker(k):
        return [(i, fn(items[i], devices[k]))
                for i in range(k, len(items), n)]

    out = [None] * len(items)
    with ThreadPoolExecutor(max_workers=max(min(n, len(items)), 1),
                            thread_name_prefix="xsi-device") as pool:
        futures = [pool.submit(worker, k) for k in range(min(n, len(items)))]
        for fut in futures:
            for i, res in fut.result():
                out[i] = res
    return out


class MeshBlockEncoder:
    """Multi-device block encode: a batch of buffered blocks spreads over
    the device pool (the generalised form of the reference's 2-thread
    split, xsqueezeit.cpp:120-148).  Each block's payload is assembled by
    the SAME host code as the single-device path, so the container bytes
    are identical whatever the device count."""

    def __init__(self, devices: list, mac_threshold: int):
        self.devices = list(devices)
        self.n_dev = len(self.devices)
        self.mac_threshold = int(mac_threshold)
        #: Payload bytes of the last batch (the JAX program's psum).
        self.total_bytes = 0

    def encode_batch(self, encoders: list) -> list[bytes]:
        """encoders: TorchBlockEncoder instances holding buffered records.
        Returns each block's serialized payload, in order."""
        def encode(enc, device):
            enc.device = torch.device(device)
            prep = enc.prepare()
            return enc.assemble(enc.encode_prepared(prep), prep)

        payloads = map_blocks(encode, encoders, self.devices)
        self.total_bytes = sum(len(p) for p in payloads)
        return payloads
