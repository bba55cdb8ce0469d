"""flush_device_ms.dotprod: device milliseconds a block of the run flush
(ops/pbwt_torch.py _decode_run: pbwt_kernels.decode_run_flush, the
chunks' composition and the flush, a CTA a chunk up to 65,535 slots,
else a cluster of 8 CTAs a chunk), from the traced run's profile: the
union of the kernels, copies and sets launched inside the program's
`decode.flush` marks, over the window's blocks decoded on the device (its
`decode.device` spans)."""
from benchmark.harness import decode_marks, program_spans


def install(probe):
    program_spans.enable()


def read(run):
    return decode_marks.device_ms_a_block(run, "decode.flush")
