"""The benchmark's plain reference: what ``compress(data)`` has to return.

NumPy and the standard library only.  It imports nothing of the measured
package and takes nothing that the package has made: given the same input
bytes it works out the model, the padding, the coded stream, the raw-block
rule, the CRCs and the container anew, so that a container the program
returns can be compared with it byte for byte.

- ``config``: the size-adaptive shape rule (``RansConfig.auto``).
- ``model``: the histogram and the exact normalisation (main.cpp:49-129).
- ``word``: the WORD encoder (rans_word_sse41.h), vectorised over lanes and
  blocks.  Another variant adds a module of its name with the same
  ``encode_blocks``.
- ``container``: the TRNS v2 container writer and a header reader
  (docs/FORMAT.md).
- ``codec``: ``compress``, the four put together.
"""
