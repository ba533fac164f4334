"""Device-stream milliseconds of the decoder's four stages (symbols,
MTF^-1 + RLE2, inverse BWT, RLE1^-1) a MiB decoded: ``decoder.STAGE_WALL``
(CUDA events at the stage boundaries, host launch gaps included), summed
from the window's start until every call has returned, over the MiB of
the same calls, those begun in the window."""


def start(probe):
    from bzip2_tpu_torch import decoder
    decoder.reset_telemetry()


def read(probe):
    from bzip2_tpu_torch import decoder
    wall = sum(decoder.STAGE_WALL.values())
    if not wall or not probe.mib_started:
        return None
    return wall * 1e3 / probe.mib_started
