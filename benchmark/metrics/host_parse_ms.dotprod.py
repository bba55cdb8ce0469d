"""host_parse_ms.dotprod: host milliseconds a block in the host block
decode's parse, host clock around TorchBlockDecoder construction and
TorchBlockDecoder.host_inputs."""
MODULE = "xsqueezeit_tpu_torch.codec.decoder_torch"
CALLS = ("TorchBlockDecoder.__init__", "TorchBlockDecoder.host_inputs")


def install(probe):
    for attr in CALLS:
        probe.span(MODULE, attr, "host parse")


def read(run):
    spans = [run.probe.span(MODULE, a, "host parse") for a in CALLS]
    blocks = spans[0].calls()
    return sum(s.total_ms() for s in spans) / blocks if blocks else None
