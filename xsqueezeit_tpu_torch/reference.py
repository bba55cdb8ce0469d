"""The host codec the port is held against.

The per-record NumPy encoder and decoder of the JAX package (jax-free
modules) define the byte-exact payload contract; scripts and checks of the
port take them from here.
"""
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder

__all__ = ["GtBlockDecoder", "GtBlockEncoder"]
