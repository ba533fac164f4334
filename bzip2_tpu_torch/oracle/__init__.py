# Copied from bzip2_tpu/oracle/__init__.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Reference-exact NumPy/Python block codec ("the oracle").

This package pins the *semantics* of every block-codec stage in clear,
testable host code.  It is the port's third backend, run only when a caller
names it: ``api.compress(..., backend="oracle")`` encodes each block here
(the RLE1 split and the periodic origPtr corrector are still the native
runtime's), and ``api.decompress``, ``stream.Decompressor``, ``BZ2TFile``
and ``bz2t -d`` with ``backend="oracle"`` decode here in pure Python.  It
never touches the card and shares no code with the card path
(``bzip2_tpu_torch.ops`` / ``engine`` / ``decoder``) or the C++ decoders,
so the card's streams can be held against it.  It is held bit-for-bit
against stock bzip2 output (stdlib ``bz2``) and the golden samples.
"""
