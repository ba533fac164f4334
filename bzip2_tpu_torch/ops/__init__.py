"""Device ops of the PyTorch port: the BWT, MTF+RLE2, group search, code
assignment and bit packing, and the wrappers of the hand-written kernels."""
