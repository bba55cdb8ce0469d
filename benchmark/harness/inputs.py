"""Inputs every operation shares: the seed's panel as a BCF, the
container the program's own `-c` makes of it, and the logical bytes of a
panel (records x 2 * samples x 4 B: the htslib gt array, the unit of the
reference's loading_time)."""
from __future__ import annotations

import hashlib
import os

from . import gen


def logical_bytes(cfg: dict, records: int | None = None) -> int:
    n = int(cfg["records"]) if records is None else records
    return n * 2 * int(cfg["samples"]) * 4


def panel_bcf(run) -> str:
    """The seed's panel written as a BCF in the run's directory."""
    path = os.path.join(run.workdir, "panel.bcf")
    gen.write_bcf(path, run.cell.config, run.seed, run.device)
    return path


def compress_args(cfg: dict, src: str, dst: str, device: str) -> list[str]:
    """`xsqueezeit -c` of `src` into `dst` with the configuration's block
    length and threshold."""
    return ["-c", "-f", src, "-o", dst, "--device", device,
            "--variant-block-length", str(cfg["block_length"]),
            "--maf", str(cfg["maf"])]


def cli(argv: list[str]) -> None:
    """The program's command line in this process; a non-zero exit
    raises."""
    from xsqueezeit_tpu_torch.cli import main
    rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"xsqueezeit {' '.join(argv[:3])} exited {rc}")


def container(run) -> str:
    """The panel compressed by the program (`-c` on the run's device),
    its BCF input removed."""
    src = panel_bcf(run)
    xsi = os.path.join(run.workdir, "panel.xsi")
    cli(compress_args(run.cell.config, src, xsi, run.device))
    os.unlink(src)
    return xsi


def outdir(run) -> str:
    path = os.path.join(run.workdir, "out")
    os.makedirs(path, exist_ok=True)
    return path


def digest(*paths: str) -> str:
    """sha256 of the files' bytes back to back ("absent" where one is
    missing: the check's read-back counts that output)."""
    h = hashlib.sha256()
    for p in paths:
        try:
            with open(p, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
        except FileNotFoundError:
            return "absent"
    return h.hexdigest()


def unlike(records, paths_of) -> int:
    """How many operations' output files differ, byte for byte, from the
    first one's (`paths_of(record)` lists an operation's files)."""
    digests = [digest(*paths_of(r)) for r in records]
    return sum(d != digests[0] for d in digests)
