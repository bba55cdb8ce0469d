"""fold_ms.extract: host milliseconds a block in the host block decode,
xsqueezeit_tpu_torch.codec.decoder_torch.decode_block_records as the
decompressor calls it (the gt fold and overlays), host clock."""
MODULE = "xsqueezeit_tpu_torch.codec.decompressor"


def install(probe):
    probe.span(MODULE, "decode_block_records", "host fold")


def read(run):
    span = run.probe.span(MODULE, "decode_block_records", "host fold")
    return span.total_ms() / span.calls() if span.calls() else None
