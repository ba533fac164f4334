"""``compress``: ``bzip2_tpu_torch.compress(object, level, **engine)``; its
stream must equal ``bz2.compress`` at the level."""
from __future__ import annotations

from portbench import reference
from portbench.workload import BaseOp


class Op(BaseOp):
    op = "compress"
    KW_KEY = "engine"

    def _program(self, k: int) -> bytes:
        return self._port.compress(self.pool[k], self.level, **self.kw)

    def _control(self, k: int) -> bytes:
        return reference.control_compress(self.pool[k], self.level)

    def warm(self, clients: int) -> None:
        """A full batch of the largest object's blocks on each of the
        engine's worker streams (their BWT plans and graphs are made for
        the cell's most rows), then the concurrent rounds."""
        from bzip2_tpu_torch import engine as E
        from bzip2_tpu_torch import rle1

        eng = E.engine_for(**self.kw)
        if self.fn == self._program and eng.use_device:
            big = max(self.pool, key=len)
            blocks = rle1.encode_blocks(big, self.level)
            bsz = min(len(blocks), eng._batch_size_for(self.level))
            arrays = E.batch_arrays(blocks[:bsz], bsz,
                                    E._block_pad_size(self.level))
            for i in range(eng.pipeline):
                with E.worker_context(eng.device, i):
                    eng.encode_batch(self.level, *arrays)
        super().warm(clients)

    def expected(self, used: list) -> dict:
        streams = reference.compress_all([self.pool[k] for k in used],
                                         self.level)
        return dict(zip(used, streams))
