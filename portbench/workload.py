"""What a client calls: the base of every operation
(``portbench/ops/<op>.py``, class ``Op``), and the warm-up's concurrent
rounds.

The timed path is the port's public entry points alone, such as
``bzip2_tpu_torch.compress(data, level, **engine)`` and
``bzip2_tpu_torch.decompress(stream, **decoder)``.  A traffic mix names
its ``op``; the configuration gives the level and the op's arguments
(under the op's ``KW_KEY``).
"""
from __future__ import annotations

import threading


def run_round(call, clients: int, pool_n: int) -> None:
    """One call a client, all at once, on objects 0..clients-1 (mod the
    pool); the first error is raised after every call has returned."""
    errors: list = []

    def one(i):
        try:
            call(i % pool_n)
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    ts = [threading.Thread(target=one, args=(i,)) for i in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]


class BaseOp:
    """One program call on object ``k`` of the pool.  A subclass names
    ``op`` (the end-to-end metrics are ``<op>_MBps`` and ``<op>_p95_ms``)
    and ``KW_KEY``, and gives ``_program(k)``, ``_control(k)`` (the
    reference's control in the program's place) and ``expected(used)``
    (the reference's output of each object index in ``used``)."""

    op = ""
    KW_KEY = ""

    def __init__(self, config: dict, pool: list, extra: dict | None = None):
        import bzip2_tpu_torch as port

        self.level = int(config["level"])
        self.kw = dict(config.get(self.KW_KEY, {}), **(extra or {}))
        self.pool = pool
        self._port = port
        self.fn = self._program

    def _program(self, k: int):
        raise NotImplementedError

    def _control(self, k: int):
        raise NotImplementedError

    def expected(self, used: list) -> dict:
        raise NotImplementedError

    def use_control(self) -> None:
        self.fn = self._control

    def call(self, k: int):
        return self.fn(k)

    def raw_bytes(self, k: int) -> int:
        return len(self.pool[k])

    def warm(self, clients: int) -> None:
        """Two rounds of concurrent calls at the cell's client count."""
        for _ in range(2):
            run_round(self.call, clients, len(self.pool))
