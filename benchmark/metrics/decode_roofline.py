"""decode_roofline.<cell>: the device decode's share of its roofline, %:
the blocks' byte bound (harness/bounds.py: stored WAH and sparse streams
read once, L x H decoded entries written once, at 3.35 TB/s) over their
device time, the union of the kernels, copies and sets launched inside
the "device decode" mark around decoder_torch._decode_block_vals (the
traced run's profile)."""
from benchmark.harness.bounds import bound_ms, decode_block_bytes

MODULE = "xsqueezeit_tpu_torch.codec.decoder_torch"
LABEL = "device decode"


def install(probe):
    probe.span(MODULE, "_decode_block_vals", LABEL,
               nbytes=decode_block_bytes)


def read(run):
    nbytes = run.probe.span(MODULE, "_decode_block_vals", LABEL).bytes()
    device_s = (run.traced or {}).get("device_s_under", {}).get(LABEL)
    if not nbytes or not device_s or None in nbytes:
        return None
    return 100.0 * sum(bound_ms(b) for b in nbytes) / (device_s * 1e3)
