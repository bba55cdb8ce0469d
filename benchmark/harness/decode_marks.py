"""Readings of the program's decode.chain and decode.flush spans
(xsqueezeit_tpu_torch/ops/pbwt_torch.py _decode_run) over a traced run's
window, for the chain and run flush metrics: the device time under a
span's marks a block, and the share of its roofline.  A program without
these spans (an older checkout) gives None, and nothing raises."""
from __future__ import annotations

from . import program_spans
from .bounds import bound_ms


def _found(run, label: str) -> tuple[list, list, float | None]:
    """(the window's blocks decoded on the device (their decode.device
    spans), the spans named `label`, the device seconds under its
    marks)."""
    ops = program_spans.operations(run, "dot_prod")
    device_s = (run.traced or {}).get("device_s_under", {}).get(label)
    return (program_spans.named(ops, "decode.device"),
            program_spans.named(ops, label), device_s)


def device_ms_a_block(run, label: str) -> float | None:
    """Device milliseconds under the `label` marks over the window's
    blocks decoded on the device."""
    blocks, found, device_s = _found(run, label)
    return device_s * 1e3 / len(blocks) if found and blocks and device_s \
        else None


def roofline_pct(run, label: str, span_bytes) -> float | None:
    """100 x the byte bound of the `label` spans (`span_bytes(span)`, None
    for a span without its shape) over the device time under their
    marks."""
    _, found, device_s = _found(run, label)
    nbytes = [span_bytes(s) for s in found]
    if not nbytes or not device_s or None in nbytes:
        return None
    return 100.0 * bound_ms(sum(nbytes)) / (device_s * 1e3)
