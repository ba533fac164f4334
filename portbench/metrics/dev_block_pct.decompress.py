"""Share of the blocks handed to the card decoder whose bytes came from the
card (``decoder.SHARE``: ``dev_blocks`` over ``blocks``); a block healed
on the host is waste.  Both counted over the calls begun in the window,
from its start until every call has returned."""


def start(probe):
    from bzip2_tpu_torch import decoder
    decoder.reset_telemetry()


def read(probe):
    from bzip2_tpu_torch import decoder
    blocks = decoder.SHARE.get("blocks", 0)
    return 100.0 * decoder.SHARE["dev_blocks"] / blocks if blocks else None
