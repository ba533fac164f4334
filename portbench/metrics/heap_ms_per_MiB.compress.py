"""Host milliseconds of the group search's Huffman heap a MiB compressed
(``native.make_code_lengths_batch``, four calls a hybrid batch): the
benchmark's wrapper around it, over the calls begun in the window, each to
its end, and over the MiB of those calls."""


def install(probe):
    from bzip2_tpu_torch import native
    probe.wrap(native, "make_code_lengths_batch", "heap")


def read(probe):
    if not probe.mib_started or not probe.window_spans("heap"):
        return None
    return probe.seconds_from_window("heap") * 1e3 / probe.mib_started
