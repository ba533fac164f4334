"""Host milliseconds of the RLE1 split a MiB compressed: the benchmark's
wrapper around ``bzip2_tpu_torch.rle1.encode_blocks`` (which ``api``
calls, and which runs ``native.rle1_split``), summed over every client's
calls that began in the window, over the bytes they split."""


def install(probe):
    from bzip2_tpu_torch import rle1
    probe.wrap(rle1, "encode_blocks", "split",
               size=lambda args, out: len(args[0]))


def read(probe):
    spans = probe.window_spans("split")
    mib = sum(s[4] for s in spans) / 2 ** 20
    if not mib:
        return None
    return probe.span_seconds("split") * 1e3 / mib
