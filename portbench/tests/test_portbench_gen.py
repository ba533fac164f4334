"""The traffic generator: deterministic by seed, exact sizes, the shapes
its docstring promises."""
import re

import numpy as np
import pytest

from portbench import gen

TEXT = {"op": "compress", "clients": 2, "pool": 3, "object_bytes": 200_000,
        "data": {"kind": "text", "language_seed": 20261018,
                 "vocabulary": 2000, "phrase_share": 0.3, "zipf_s": 1.0, "zipf_q": 2.7, "sentence_words": 17,
                 "comma_p": 0.07, "line_chars": 72, "paragraph_p": 0.12}}
LOGS = {"op": "compress", "clients": 2, "pool": 3, "object_bytes": 200_000,
        "data": {"kind": "logs", "language_seed": 20261018,
                 "templates": 50, "components": 10, "hosts": 40, "id_pool": 500, "zipf_s": 1.1,
                 "mean_gap_ms": 3.0}}


@pytest.mark.parametrize("traffic", [TEXT, LOGS], ids=["text", "logs"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 12345, 2 ** 40 + 3, -7])
def test_same_seed_same_pool(traffic, seed):
    a = gen.make_pool(traffic, seed, threads=3)
    b = gen.make_pool(traffic, seed, threads=1)
    assert a == b
    assert len(a) == 3 and all(len(o) == 200_000 for o in a)
    assert len(set(a)) == 3            # distinct objects
    assert gen.make_pool(traffic, seed + 1)[0] != a[0]


def test_language_is_the_traffic_files():
    """Two run seeds draw different objects from one vocabulary."""
    a, b = (gen.make_pool(TEXT, s)[0] for s in (1, 2))
    words = [set(re.findall(rb"[a-z]{4,}", d)) for d in (a, b)]
    assert a != b
    assert len(words[0] & words[1]) > 0.5 * len(words[0])


def test_pool_has_an_object_a_client():
    assert len(gen.make_pool(dict(TEXT, clients=5), 1)) == 5


def test_text_is_prose():
    d = gen.make_pool(TEXT, 11)[0]
    assert set(d) <= set(b"abcdefghijklmnopqrstuvwxyz"
                         b"ABCDEFGHIJKLMNOPQRSTUVWXYZ .,?!\n")
    words = re.findall(rb"[A-Za-z]+", d)
    assert 3.5 < np.mean([len(w) for w in words]) < 7.0
    lines = d.split(b"\n")
    assert max(len(x) for x in lines[:-1]) < 200
    assert re.search(rb"\. [A-Z]", d)          # sentences
    assert b"\n\n" in d                         # paragraphs


def test_logs_lines_and_rising_time():
    d = gen.make_pool(LOGS, 5)[0]
    lines = d.split(b"\n")[:-1]
    pat = re.compile(rb"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} "
                     rb"(INFO|WARN|ERROR|DEBUG) org\.[a-z.]+[A-Za-z]+: \S")
    assert all(pat.match(x) for x in lines)
    stamps = [x[:23] for x in lines]
    assert stamps == sorted(stamps)
    # templates recur: many lines share their first 30 bytes after the time
    bodies = [x[24:54] for x in lines]
    assert len(set(bodies)) < len(bodies) // 2


def test_sizes_are_one_set_in_the_seeds_order():
    """A list of sizes: every seed's pool holds the same sizes, repeated
    to the pool's length, in an order of its own."""
    mixed = dict(LOGS, pool=5, object_bytes=[1000, 5000, 30_000])
    want = [1000, 1000, 5000, 5000, 30_000]
    orders = set()
    for seed in range(6):
        pool = gen.make_pool(mixed, seed)
        assert sorted(len(o) for o in pool) == want
        assert [len(o) for o in pool] == gen.object_sizes(mixed, seed)
        orders.add(tuple(len(o) for o in pool))
    assert len(orders) > 1


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError):
        gen.make_pool(dict(TEXT, data={"kind": "nope",
                                       "language_seed": 1}), 1)


def test_assemble_gathers_segments():
    pool = np.frombuffer(b"hello world", np.uint8)
    out = gen.assemble(pool, np.array([6, 5, 0]), np.array([5, 1, 5]))
    assert out.tobytes() == b"world hello"
