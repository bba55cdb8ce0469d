"""Streaming compression driver on the torch codec: VCF/BCF -> .xsi.

Port of xsqueezeit_tpu/codec/compressor.py (compress_file, :456-546).
Everything but the block encoder is the JAX package's own driver, which
imports no jax: the record loops, the variant file, the CSI index and the
container writer.  Blocks encode with TorchBlockEncoder on the chosen
device, one device and no mesh; device="numpy" keeps the host encoder.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

# before the container: it imports zstandard, which may be missing
from ..format import zstd_shim  # noqa: F401  isort: skip
from xsqueezeit_tpu.codec import compressor as _base
from xsqueezeit_tpu.format.constants import (
    XSI_BCF_VAR_EXTENSION,
    WeirdnessStrategy,
)
from xsqueezeit_tpu.format.container import XsiWriter
from xsqueezeit_tpu.format.header import XsiHeader
from xsqueezeit_tpu.io.bcf import BcfWriter
from xsqueezeit_tpu.io.csi import CsiBuilder, depth_for_max_len
from xsqueezeit_tpu.io.unified import (
    GtInput,
    sniff_default_phased,
    sniff_max_ploidy_first_entry,
)

from ..utils.devprobe import torch_device
from .encoder_torch import TorchBlockEncoder


@dataclass
class CompressorOptions(_base.CompressorOptions):
    device: str = "cuda"  # "cuda" | "cpu" | "numpy"


class TorchEncodeDispatcher(_base.BlockEncodeDispatcher):
    """BlockEncodeDispatcher whose device encoder is TorchBlockEncoder on
    `device` (None: the host encoder).

    The device was chosen explicitly, so every block of ploidy 1 or 2,
    mixed ploidy included, takes it (no size threshold, no reachability
    probe)."""

    def __init__(self, n_samples, block_length, mac_threshold,
                 default_phasing, aet_dtype, weirdness_strategy,
                 device: torch.device | None):
        device_cls = (None if device is None
                      else functools.partial(TorchBlockEncoder, device=device))
        super().__init__(n_samples, block_length, mac_threshold,
                         default_phasing, aet_dtype, weirdness_strategy,
                         device_cls=device_cls,
                         force_device=device_cls is not None)

    def _probe_mesh(self):
        return None   # one device; multi-GPU is a later PR of the port


def compress_file(input_path: str, output_path: str,
                  opts: CompressorOptions | None = None) -> dict:
    """Compress `input_path` into `output_path` (+ `_var.bcf` + `.csi`).

    Returns summary stats.  The container is byte-identical to the JAX
    package's for the same options, whichever device encodes."""
    opts = opts or CompressorOptions()
    device = torch_device(opts.device)    # fails before any file is opened
    inp = GtInput(input_path)
    samples = inp.samples
    if not samples:
        raise ValueError(f"File {input_path} has no samples")
    n_samples = len(samples)

    default_phased = sniff_default_phased(input_path)
    max_ploidy = sniff_max_ploidy_first_entry(input_path)
    if max_ploidy == 0:
        raise ValueError(f"File {input_path} has no GT entries")

    n_haps = n_samples * 2  # A_T selection always assumes diploid
    aet_dtype = np.uint16 if n_haps <= 0xFFFF else np.uint32
    mac_threshold = int(n_haps * opts.maf)
    ws = (WeirdnessStrategy.WS_WAH if opts.wah_encode_missing
          else WeirdnessStrategy.WS_SPARSE)

    header = XsiHeader(
        version=5, ind_bytes=4, aet_bytes=np.dtype(aet_dtype).itemsize,
        wah_bytes=2, iota_ppa=True, no_sort=False,
        default_phased=bool(default_phased), ss_rate=opts.block_length,
        rare_threshold=mac_threshold)
    block = TorchEncodeDispatcher(
        n_samples, opts.block_length, mac_threshold,
        default_phasing=default_phased, aet_dtype=aet_dtype,
        weirdness_strategy=ws, device=device)
    xsi = XsiWriter(output_path, header, samples,
                    zstd_on=opts.zstd, zstd_level=opts.zstd_level)

    var_path = output_path + XSI_BCF_VAR_EXTENSION
    var_header = _base.make_variant_header(inp.header,
                                           os.path.basename(output_path))
    native_var = _base._native_var_pass_eligible(inp)
    var_writer = csi = None
    if not native_var:
        var_writer = BcfWriter(var_path, var_header)
        csi = CsiBuilder(depth=depth_for_max_len(
            max(var_header.contig_lengths.values(), default=0)))
    try:
        if native_var:
            return _base._compress_loop_native_var(inp, opts, xsi, block,
                                                   output_path, max_ploidy)
        return _base._compress_loop(inp, opts, xsi, var_writer, var_header,
                                    csi, block, var_path, output_path,
                                    max_ploidy)
    except BaseException:
        # no leaked worker thread, no half-written output
        block.shutdown()
        for f in (getattr(xsi, "f", None),
                  getattr(var_writer, "_f", None) if var_writer else None):
            if f is not None and not f.closed:
                f.close()
        for path in (output_path, var_path, var_path + ".csi"):
            try:
                os.unlink(path)
            except OSError:
                pass
        raise
    finally:
        block.shutdown()
        inp.close()
