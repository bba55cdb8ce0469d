"""mixed_device_ms.dotprod: device milliseconds a mixed-ploidy block's
decode takes (codec/decoder_torch.py _decode_block_mixed: the WAH expand
at each line's width, the mixed scan's runs on the chains and the run
flush, the sparse lines), from the traced run's profile: the union of the
kernels, copies and sets launched inside the program's `decode.mixed`
marks, over the window's mixed blocks (its `decode.mixed` spans).  A
program without the span gives None."""
from benchmark.harness import program_spans

LABEL = "decode.mixed"


def install(probe):
    program_spans.enable()


def read(run):
    found = program_spans.named(program_spans.operations(run, "dot_prod"),
                                LABEL)
    device_s = (run.traced or {}).get("device_s_under", {}).get(LABEL)
    return device_s * 1e3 / len(found) if found and device_s else None
