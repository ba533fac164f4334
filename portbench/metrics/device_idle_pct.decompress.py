"""Share of the traced window in which no kernel or copy ran on the card,
in a decompress cell: as ``device_idle_pct.compress``."""


def read(probe):
    w = probe.window_s()
    if not w or not probe.device:
        return None
    return 100.0 * (1.0 - probe.busy_s() / w)
