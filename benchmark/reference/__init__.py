"""The plain reference the benchmark holds the program's outputs against.

It regenerates the seed's panel itself (the benchmark's generator,
``benchmark/harness/gen.py``), computes dot products in float64, and reads
the program's BCF outputs with a reader of its own (``bcf.py``, written
from the BCF2 specification, not copied from the program).  It imports
nothing of the program (xsqueezeit_tpu_torch), of JAX or of the JAX
package (xsqueezeit_tpu); ``benchmark/tests`` holds it to that.
"""
