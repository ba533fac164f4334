"""Log rotation, the ``logrotate-9`` deployment: server logs of the
benchmark's ``compress-logs`` traffic (``portbench/kinds/logs.py``) through
the port, byte for byte stock bzip2's, and the BWT stage they drive that
text does not: the full-width doubling rounds (stage 0) after the 16-byte
key sort.  The card's own round counts (``ops.bwt.stage_rounds``) are held
against the round record on the card (``cuda``)."""
import bz2 as stdlib_bz2
import json
import os

import numpy as np
import pytest
import torch

import bzip2_tpu_torch
from bzip2_tpu_torch import native, rle1
from bzip2_tpu_torch.ops import bwt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="the engine needs the native runtime")
#: bzip2's largest block at -9 (nblockMAX: 900,000 - 19)
BLOCK_9 = 899_981


def _object(traffic: str, seed: int, nbytes: int) -> bytes:
    """An object of the traffic's kind, as the benchmark's pool makes its
    first one for ``seed``."""
    from portbench import cells, gen
    with open(os.path.join(ROOT, "portbench", "traffic",
                           traffic + ".json")) as fh:
        data = dict(json.load(fh)["data"])
    kind = cells.kind(data.pop("kind"), ROOT)
    maker = kind.Maker(int(data.pop("language_seed")), data)
    return maker.object(gen.rng_for(seed, kind.TAG, 1), nbytes).tobytes()


def _first_block(traffic: str, seed: int):
    """The first -9 block of a 1 MiB object: (uint8 (1, 899,981), n)."""
    block = rle1.encode_blocks(_object(traffic, seed, 1 << 20), 9)[0].data
    assert block.size == BLOCK_9
    return (torch.from_numpy(np.array(block))[None],
            torch.tensor([BLOCK_9], dtype=torch.int32))


def _rounds_by_stage(monkeypatch, blocks, n) -> dict:
    """{stage: doubling rounds} of one ``bwt_batched`` call, from its round
    record (the initial 16-byte ranks are not a round)."""
    rows = []
    monkeypatch.setattr(bwt, "ROUND_HOOK",
                        lambda stage, k, unres: rows.append((stage, k)))
    bwt.bwt_batched(blocks, n)
    monkeypatch.setattr(bwt, "ROUND_HOOK", None)
    assert rows[0] == (0, 16)
    out: dict = {}
    for stage, _k in rows[1:]:
        out[stage] = out.get(stage, 0) + 1
    return out


@needs_native
@pytest.mark.parametrize("seed,level", [(2147493999, 9), (7, 9),
                                        (2147493999, 1), (7, 1)])
def test_logs_compress_equals_stock_bzip2(seed, level):
    obj = _object("compress-logs", seed, (1 << 20) + 4099 * (seed % 5))
    assert bzip2_tpu_torch.compress(obj, level, host_workers=0,
                                    device="cpu") \
        == stdlib_bz2.compress(obj, level)


@needs_native
def test_logs_block_runs_full_width_rounds_and_text_none(monkeypatch):
    """69% of a logs block's positions are tied after the key sort, so it
    takes full-width rounds before the tail ladder; a text block of the
    same length goes straight to the tail stages."""
    logs = _rounds_by_stage(monkeypatch, *_first_block("compress-logs", 7))
    text = _rounds_by_stage(monkeypatch, *_first_block("compress-text", 7))
    assert logs.get(0, 0) >= 1
    assert text.get(0, 0) == 0 and sum(text.values()) >= 1


def test_stage_rounds_without_a_card(monkeypatch):
    """Without a card the loops run on the host and count nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bwt.stage_rounds() is None


def test_stage_rounds_add_what_a_plan_folds(monkeypatch):
    """A plan's fold adds the rounds its loops' counts rose by since the
    last fold, stage by stage; a second fold of the same counts adds
    nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bwt, "_ROUNDS", [0] * len(bwt._ROUNDS))
    plan = bwt._Plan(1, 1000, torch.device("cpu"))
    stages = len(plan.loops)
    plan.counts = torch.zeros((stages, 2), dtype=torch.int32)
    plan.counts[0] = torch.tensor([1, 2])
    plan.counts[stages - 1] = torch.tensor([1, 1])
    plan.fold()
    assert bwt.stage_rounds()[:stages] == [2] + [0] * (stages - 2) + [1]
    plan.counts[0] = torch.tensor([2, 5])
    plan.fold()
    plan.fold()
    assert bwt.stage_rounds()[0] == 5
    assert sum(bwt.stage_rounds()) == 6


@pytest.mark.cuda
def test_stage_rounds_rise_by_the_rounds_the_card_ran(monkeypatch):
    """On the card ``stage_rounds`` rises, stage by stage, by the rounds
    the round record shows for a logs and a text block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [[t.to(dev) for t in _first_block(traffic, 2147493999)]
             for traffic in ("compress-logs", "compress-text")]
    bwt.bwt_batched(*cases[0])              # the plan and its graphs
    before = bwt.stage_rounds()
    want = [0] * len(before)
    for blocks, n in cases:
        for stage, rounds in _rounds_by_stage(monkeypatch, blocks,
                                              n).items():
            want[stage] += rounds
    after = bwt.stage_rounds()
    assert [b - a for a, b in zip(before, after)] == want
    assert want[0] >= 1
