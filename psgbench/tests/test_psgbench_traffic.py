"""The traffic generator: fixed work per seed, reproducible from the seed."""

import itertools

import numpy as np

from psgbench import traffic as gen
from psgbench.weights import sub_seed
from tiny import load

BIG = 2 ** 31 + 977


def test_mix_has_fixed_counts_and_is_reproducible():
    assert gen.image_sizes(load("traffic", "vga_landscape_mb4.json")["mix"], BIG) == [(480, 640)] * 16
    mix = [{"hw": [480, 640], "count": 28}, {"hw": [640, 480], "count": 8},
           {"hw": [640, 640], "count": 4}]
    a, b, c = (gen.image_sizes(mix, s) for s in (BIG, BIG, BIG + 1))
    assert a == b and a != c
    assert sorted(a) == sorted(c)
    assert a.count((480, 640)) == 28 and a.count((640, 480)) == 8 and a.count((640, 640)) == 4
    ims = gen.make_images(a[:3], BIG)
    again = gen.make_images(a[:3], BIG)
    assert all(x.shape == (h, w, 3) and x.dtype == np.uint8 for x, (h, w) in zip(ims, a[:3]))
    assert all(np.array_equal(x, y) for x, y in zip(ims, again))


def test_chunks_group_by_bucket():
    buckets = [(2, 3)] * 5 + [(3, 3)] * 2 + [(2, 3)]
    ch = gen.chunks_by_bucket(buckets, 4)
    assert ch[0][0] == (3, 3) and ch[0][1] == [5, 6]
    assert [c[1] for c in ch[1:]] == [[0, 1, 2, 3], [4, 7]]


def test_chunk_order_same_work_every_seed():
    b = [(1024, 1344)] * 7 + [(1344, 1024)] * 2 + [(1344, 1344)]
    seqs = [list(itertools.islice(gen.chunk_order(b, s), 25)) for s in (BIG, BIG + 5)]
    assert [b[i] for i in seqs[0]] == [b[i] for i in seqs[1]]
    assert seqs[0] != seqs[1]
    for cyc in (seqs[0][:10], seqs[0][10:20]):
        assert sorted(cyc) == list(range(10))
    assert list(itertools.islice(gen.chunk_order(b, BIG), 25)) == seqs[0]


def test_poisson_schedule():
    t = gen.poisson_arrivals(2.0, 4000, BIG)
    assert np.array_equal(t, gen.poisson_arrivals(2.0, 4000, BIG))
    assert np.all(np.diff(t) > 0)
    assert abs(4000 / t[-1] - 2.0) < 0.1


def test_sub_seeds_take_large_seeds():
    assert sub_seed(2 ** 33 + 5, 1) != sub_seed(2 ** 33 + 5, 2)
    assert 0 <= sub_seed(2 ** 40, 7) < 2 ** 63
