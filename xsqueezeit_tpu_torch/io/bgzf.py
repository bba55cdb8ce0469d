"""BGZF block-gzip container (the framing used by .bcf / .vcf.gz / .csi).

BGZF is a sequence of gzip members, each carrying a BC extra subfield with
the total compressed block size (BSIZE) minus one; uncompressed payload per
block is at most 65536 bytes, and the file ends with a fixed 28-byte empty
block (EOF marker).  Virtual file offsets are (compressed_offset << 16) |
offset_within_uncompressed_block; they address records for CSI indexing.
"""
from __future__ import annotations

import io
import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
MAX_BLOCK = 0xFF00  # keep compressed blocks under 64 KiB


def _initial_offset(f) -> int:
    """Current byte position of a wrapped file object, 0 for pipes."""
    try:
        if f.seekable():
            return f.tell()
    except (AttributeError, OSError, ValueError):
        pass
    return 0


def is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _compress_block(data: bytes, level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = c.compress(data) + c.flush()
    bsize = len(payload) + 25 + 1  # header(18) + payload + crc(4) + isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,       # magic, deflate, FEXTRA
        0, 0, 0xFF,             # mtime, xfl, os
        6,                      # xlen
        0x42, 0x43, 2,          # 'B','C', slen
        bsize - 1)
    return header + payload + struct.pack("<II", zlib.crc32(data), len(data))


class BgzfWriter(io.RawIOBase):
    """BGZF writer, optionally with parallel block deflate.

    BGZF members are independent gzip streams, so `threads > 0` hands each
    64 KiB block to a thread pool (zlib releases the GIL) and writes the
    compressed members back in order — the same design as htslib's bgzf
    thread pool, which dominates its own write path.  tell_virtual() needs
    the exact compressed offset, so calling it drains the pipeline first;
    writers that index while writing (the variant-BCF + CSI path) should
    keep threads=0.
    """

    def __init__(self, path_or_file, level: int = 6, threads: int = 0):
        if path_or_file == "-":
            import sys
            self._f = sys.stdout.buffer
            self._own = False
        elif isinstance(path_or_file, str):
            self._f = open(path_or_file, "wb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        self._level = level
        self._buf = bytearray()
        # Compressed bytes flushed, tracked by hand (stdout has no tell()).
        # Starts at the wrapped object's current position so tell_virtual()
        # stays correct when wrapping an already-positioned seekable file.
        self._coffset = _initial_offset(self._f)
        self._pool = None
        self._pending = None
        if threads > 0:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=threads)
            self._pending = deque()
            self._max_pending = threads * 4

    def writable(self):
        return True

    def write(self, data) -> int:
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK:
            self._flush_block(self._buf[:MAX_BLOCK])
            del self._buf[:MAX_BLOCK]
        return len(data)

    def _flush_block(self, chunk) -> None:
        if self._pool is not None:
            data = bytes(chunk)
            self._pending.append(
                self._pool.submit(_compress_block, data, self._level))
            while (len(self._pending) > self._max_pending
                   or (self._pending and self._pending[0].done())):
                self._write_out(self._pending.popleft().result())
            return
        self._write_out(_compress_block(bytes(chunk), self._level))

    def _write_out(self, out: bytes) -> None:
        self._f.write(out)
        self._coffset += len(out)

    def _drain(self) -> None:
        if self._pending:
            while self._pending:
                self._write_out(self._pending.popleft().result())

    def tell_virtual(self) -> int:
        """Virtual offset of the next byte to be written.

        (compressed offset of the pending block << 16) | in-block offset;
        does NOT flush -- write() keeps the pending buffer under 64 KiB, so
        the in-block offset always fits the low 16 bits.  Tracks the
        compressed offset itself: stdout pipes have no tell().
        """
        self._drain()
        return (self._coffset << 16) | len(self._buf)

    def flush_pending(self) -> None:
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()

    def finish(self, write_eof: bool = True) -> None:
        """Flush all pending data.  write_eof=False emits a BODY segment
        (BGZF members concatenate cleanly, so segments produced by
        parallel writers join into one valid file; only the final segment
        carries the 28-byte EOF marker)."""
        self.flush_pending()
        self._drain()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if write_eof:
            self._f.write(BGZF_EOF)
        self._finished = True

    def close(self) -> None:
        if self.closed:
            return
        if not getattr(self, "_finished", False):
            self.finish()
        if self._own:
            self._f.close()
        super().close()


class BgzfReader(io.RawIOBase):
    """Streaming reader with virtual-offset seek support."""

    def __init__(self, path_or_file):
        if isinstance(path_or_file, str):
            self._f = open(path_or_file, "rb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        self._block = b""
        self._block_pos = 0          # position within decompressed block
        # Compressed bytes consumed, tracked by hand (pipes have no tell();
        # seek_virtual resyncs it).  Starts at the wrapped object's current
        # position so virtual offsets are file-absolute even when the source
        # was already positioned mid-file.
        self._coffset = _initial_offset(self._f)
        self._block_coffset = self._coffset

    def readable(self):
        return True

    def _load_block(self) -> bool:
        self._block_coffset = self._coffset
        header = self._f.read(18)
        self._coffset += len(header)
        if len(header) < 18:
            self._block = b""
            self._block_pos = 0
            return False
        if header[:2] != b"\x1f\x8b":
            raise ValueError("BGZF: bad gzip magic")
        xlen = struct.unpack_from("<H", header, 10)[0]
        extra = header[12:18]
        # find BC subfield
        bsize = None
        if xlen > 6:
            more = self._f.read(xlen - 6)
            self._coffset += len(more)
            buf = extra + more
        else:
            buf = extra
        off = 0
        while off + 4 <= len(buf):
            si1, si2, slen = buf[off], buf[off + 1], struct.unpack_from("<H", buf, off + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", buf, off + 4)[0] + 1
                break
            off += 4 + slen
        if bsize is None:
            raise ValueError("BGZF: missing BC subfield")
        comp_len = bsize - 12 - xlen - 8
        payload = self._f.read(comp_len)
        tail = self._f.read(8)
        self._coffset += len(payload) + len(tail)
        crc, isize = struct.unpack("<II", tail)
        self._block = zlib.decompress(payload, -15) if isize else b""
        self._block_pos = 0
        return True

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._block_pos >= len(self._block):
                if not self._load_block():
                    break
                if not self._block:
                    continue
            take = len(self._block) - self._block_pos if n < 0 else \
                min(n - len(out), len(self._block) - self._block_pos)
            out.extend(self._block[self._block_pos:self._block_pos + take])
            self._block_pos += take
        return bytes(out)

    def tell_virtual(self) -> int:
        if self._block_pos >= len(self._block):
            return self._coffset << 16
        return (self._block_coffset << 16) | self._block_pos

    def seek_virtual(self, voffset: int) -> None:
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        self._f.seek(coffset)
        self._coffset = coffset
        if not self._load_block() and uoffset:
            raise ValueError("BGZF: seek past EOF")
        self._block_pos = uoffset

    def close(self) -> None:
        if self.closed:
            return
        if self._own:
            self._f.close()
        super().close()
