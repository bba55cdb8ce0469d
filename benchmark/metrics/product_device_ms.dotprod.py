"""product_device_ms.dotprod: device milliseconds a block's product takes
(bench/tools.py: the rows' gather, their float32 copy, the gemv, the mixed
route's select), from the traced run's profile: the union of the kernels,
copies and sets launched inside the program's `dot_prod.product` marks,
over the window's product spans."""
from benchmark.harness import program_spans

LABEL = "dot_prod.product"


def install(probe):
    program_spans.enable()


def read(run):
    found = program_spans.named(program_spans.operations(run, "dot_prod"),
                                LABEL)
    device_s = (run.traced or {}).get("device_s_under", {}).get(LABEL)
    return device_s * 1e3 / len(found) if found and device_s else None
