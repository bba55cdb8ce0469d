"""decode_device_ms.<cell>: device milliseconds a block of the whole-block
device decode (decoder_torch._decode_block_vals: the WAH expand, the
decode chains and run flush, the sparse scatter, its inputs already on
the card), from the traced run's profile: the union of the kernels,
copies and sets launched inside the "device decode" mark around the
call, over the calls in the window."""
MODULE = "xsqueezeit_tpu_torch.codec.decoder_torch"
LABEL = "device decode"


def install(probe):
    probe.span(MODULE, "_decode_block_vals", LABEL)


def read(run):
    calls = run.probe.span(MODULE, "_decode_block_vals", LABEL).calls()
    device_s = (run.traced or {}).get("device_s_under", {}).get(LABEL)
    return device_s * 1e3 / calls if calls and device_s else None
