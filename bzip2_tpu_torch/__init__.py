"""bzip2_tpu_torch: the bzip2 block encoder and decoder on PyTorch and CUDA.

The port of ``bzip2_tpu``'s encode engine, device block decoder and user
surfaces (one-shot ``api``, streaming ``BZ2Compressor`` /
``BZ2Decompressor``, ``open`` / ``BZ2File``, the ``compat`` bzopen family,
``recover`` and the ``cli``, run as ``python -m bzip2_tpu_torch.cli``) to
a PyTorch device.  The engine (``engine.Engine``) runs the reference's
work-stealing scheduler: device workers, each on its own CUDA stream,
encode batches of blocks from the front of the stream while native host
workers steal single blocks from the tail.  A device batch runs in one of
two modes: "hybrid" (the default: device stages with the four Huffman
rebuilds on the host) or "fused" (the whole block encoder on the device).
``use_device=False`` encodes on the host alone.  The TPU kernels of the
encoder (the BWT's pair sort, the two MTF rank kernels and the group
histogram), the fused mode's Huffman code lengths and the decoder's
inverse-BWT walk are written by hand in CUDA C++ for Hopper (``csrc/``,
built at first use by ``_build``).  The host side (stream framing in
``api``, ``rle1``, ``crc``, ``bitstream``, the ``periodic`` origPtr
corrector, ``tracing``, ``hostmem``, the surfaces and the C++ runtime in
``native``) is the port's own copy of ``bzip2_tpu``'s, and so is the
NumPy reference codec in ``oracle``.  Encoding runs on the card unless the
caller names backend "native" (the host engine) or "oracle" (the reference
codec); ``decompress`` here decodes on the card,
``api.decompress(..., backend="native")`` and the streaming and file
readers on the host, and backend "oracle" in pure Python.  This package
imports neither JAX nor ``bzip2_tpu``.
"""

__version__ = "0.1.0"

from .api import (BZ2Error, DataError, DataErrorMagic, UnexpectedEOF,
                  get_default_backend, set_default_backend)
from .stream import Compressor as BZ2Compressor
from .stream import Decompressor as BZ2Decompressor
from .tracing import set_verbosity, profile_trace, enable_metrics
from .tracing import collect as collect_metrics


def open(*args, **kwargs):  # noqa: A001  (mirror bz2.open)
    from .file import open as _open
    return _open(*args, **kwargs)


def BZ2File(*args, **kwargs):
    from .file import BZ2TFile
    return BZ2TFile(*args, **kwargs)


def enable_gpu_backend(**engine_kwargs) -> None:
    """Register the port's engine as block-encoder backend "gpu" for
    ``bzip2_tpu_torch.api.compress`` and make it the default.
    ``engine_kwargs`` go to :class:`bzip2_tpu_torch.engine.Engine`:
    ``batch_size``, ``mode`` (None = "hybrid", or "fused"), ``pipeline``
    (default 2), ``host_workers`` (None = 1), ``use_device`` (default True)
    and ``device`` (default ``"cuda"``).  One engine serves each distinct
    set of arguments for the life of the process
    (``engine.engine_for``)."""
    from . import api
    from .engine import engine_for

    api.register_block_encoder("gpu", engine_for(**engine_kwargs)
                               .encode_payloads)
    api.set_default_backend("gpu")


def compress(data, level: int = 9, **engine_kwargs) -> bytes:
    """Compress ``data`` into one standard .bz2 stream, every block encoded
    by the port's engine.  The stream framing, RLE1 split and periodic
    origPtr corrector are ``bzip2_tpu_torch.api``'s.  ``engine_kwargs`` are
    :func:`enable_gpu_backend`'s (``host_workers=0`` keeps every block on
    the device); calls with the same arguments share one engine, whose
    scheduler rates carry from one call to the next.  The registry and the
    default backend are left as they are."""
    from . import api
    from .engine import engine_for

    return api.compress_with(engine_for(**engine_kwargs).encode_payloads,
                             data, level)


def decompress(data, multi_stream: bool = False, **decoder_kwargs) -> bytes:
    """Decompress one .bz2 stream (or all concatenated streams if
    ``multi_stream``) on the port's device decoder; both CRC layers are
    checked.  Raises ``bzip2_tpu_torch.api``'s DataErrorMagic / DataError /
    UnexpectedEOF where the host decoder would.  ``decoder_kwargs`` go to
    :class:`bzip2_tpu_torch.decoder.DeviceDecoder` (``device`` defaults to
    ``"cuda"``)."""
    return decompress_with_tail(data, multi_stream, **decoder_kwargs)[0]


def decompress_with_tail(data, multi_stream: bool = False,
                         **decoder_kwargs) -> tuple[bytes, int]:
    """Like :func:`decompress`; also returns the byte offset where parsing
    stopped (the start of any trailing garbage or next stream)."""
    from .decoder import DeviceDecoder, default_decoder

    dec = DeviceDecoder(**decoder_kwargs) if decoder_kwargs \
        else default_decoder()
    return dec.decompress_with_tail(data, multi_stream=multi_stream)
