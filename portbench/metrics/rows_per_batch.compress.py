"""Blocks a device batch of the engine (``Engine.encode_payloads``): the
engine's own ``batch[s:e]`` spans (``tracing.enable_metrics`` /
``collect``), those that ended in the window, averaged."""


def install(probe):
    from bzip2_tpu_torch import tracing
    tracing.enable_metrics(True)


def start(probe):
    from bzip2_tpu_torch import tracing
    tracing.collect()


def read(probe):
    from bzip2_tpu_torch import tracing
    rows = []
    for r in tracing.collect():
        name = r.get("name", "")
        if (r.get("kind") == "span" and name.startswith("batch[")
                and probe.in_window(int(r["t"] * 1e9))):
            s, e = name[len("batch["):-1].split(":")
            rows.append(int(e) - int(s))
    return sum(rows) / len(rows) if rows else None
