"""chain_device_ms.dotprod: device milliseconds a block of the decode chain
(ops/pbwt_torch.py _decode_run: pbwt_kernels.chain_decode, on one CTA up
to 28,928 slots, else on 16 CTAs with its rows in device memory), from
the traced run's profile: the union of the kernels, copies and sets
launched inside the program's `decode.chain` marks, over the window's
blocks decoded on the device (its `decode.device` spans)."""
from benchmark.harness import decode_marks, program_spans


def install(probe):
    program_spans.enable()


def read(run):
    return decode_marks.device_ms_a_block(run, "decode.chain")
