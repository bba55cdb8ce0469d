"""upload_ms.dotprod: host milliseconds a block's decode inputs take to
reach the device (codec/decoder_torch.py: the pageable host-to-device
copies of the parsed streams), the program's `decode.upload` spans under
the window's `dot_prod` operations, per block."""
from benchmark.harness import program_spans


def install(probe):
    program_spans.enable()


def read(run):
    return program_spans.mean_ms(run, "dot_prod", "decode.upload")
