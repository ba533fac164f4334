"""``decompress``: ``bzip2_tpu_torch.decompress(stream, **decoder)`` of an
object's stream (made by ``bz2`` in set-up); its bytes must equal the
object."""
from __future__ import annotations

from portbench import reference
from portbench.workload import BaseOp


class Op(BaseOp):
    op = "decompress"
    KW_KEY = "decoder"

    def __init__(self, config: dict, pool: list, extra: dict | None = None):
        super().__init__(config, pool, extra)
        self.streams = reference.compress_all(pool, self.level)

    def _program(self, k: int) -> bytes:
        return self._port.decompress(self.streams[k], **self.kw)

    def _control(self, k: int) -> bytes:
        return reference.control_decompress(self.streams[k], self.level)

    def expected(self, used: list) -> dict:
        return {k: self.pool[k] for k in used}
