"""The host codec the port is held against, and its test inputs.

The per-record NumPy encoder and decoder of the JAX package (jax-free
modules) define the byte-exact payload contract; the synthetic BCF writer
and the VCF/BCF genotype reader make and read the file-level inputs, and
INT32_VECTOR_END is htslib's end-of-vector gt code.
Scripts and checks of the port take them from here.
"""
from xsqueezeit_tpu.bench.e2e import synth_bcf
from xsqueezeit_tpu.codec.gt_block import GtBlockEncoder
from xsqueezeit_tpu.codec.gt_block_decoder import GtBlockDecoder
from xsqueezeit_tpu.format.constants import INT32_VECTOR_END
from xsqueezeit_tpu.io.unified import GtInput

__all__ = ["GtBlockDecoder", "GtBlockEncoder", "GtInput", "INT32_VECTOR_END",
           "synth_bcf"]
