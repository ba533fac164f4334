"""bzip2_tpu_torch: the bzip2 block encoder on PyTorch and CUDA.

The port of ``bzip2_tpu``'s hybrid block encoder to a PyTorch device, with
the four TPU kernels of its path (the BWT's pair sort, the two MTF rank
kernels and the group histogram) written by hand in CUDA C++ for Hopper
(``csrc/``, built at first use by ``_build``).  The jax-free host modules of
``bzip2_tpu`` (RLE1, CRC, bitstream, periodic corrector, api, native heap
builder) are reused as they are.  This package imports no JAX.
"""

__version__ = "0.1.0"


def _register_gpu(engine_kwargs: dict) -> None:
    from bzip2_tpu import api

    from .engine import Engine

    api.register_block_encoder("gpu", Engine(**engine_kwargs).encode_payloads)


def enable_gpu_backend(**engine_kwargs) -> None:
    """Register the port's engine as block-encoder backend "gpu" for
    ``bzip2_tpu.api.compress`` and make it the default.  ``engine_kwargs``
    go to :class:`bzip2_tpu_torch.engine.Engine` (``device`` defaults to
    ``"cuda"``)."""
    from bzip2_tpu import api

    _register_gpu(engine_kwargs)
    api.set_default_backend("gpu")


def compress(data, level: int = 9, **engine_kwargs) -> bytes:
    """Compress ``data`` into one standard .bz2 stream, every block encoded
    by the port's engine.  The stream framing, RLE1 split and periodic
    origPtr corrector are ``bzip2_tpu.api``'s; this (re)registers backend
    "gpu" with ``engine_kwargs`` and does not change the default backend."""
    from bzip2_tpu import api

    _register_gpu(engine_kwargs)
    return api.compress(data, level, backend="gpu")
