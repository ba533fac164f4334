"""Share of the traced window in which no kernel or copy ran on the card:
100 - the busy union of the profiler's device intervals over the window
(``portbench/trace.py``, a frozen copy of ``tools.profile_device``'s
``busy_share``)."""


def read(probe):
    w = probe.window_s()
    if not w or not probe.device:
        return None
    return 100.0 * (1.0 - probe.busy_s() / w)
