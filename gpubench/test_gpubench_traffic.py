"""The request generator: deterministic by seed, inside the mix's
ranges, and the same work for every seed."""

import numpy as np

from gpubench import generator
from gpubench.conftest import mix

MIX = mix("serve_long_prompt")
BIG = 2**31 + 12345


def _draw(seed, n=256):
    return [generator.request(MIX, seed, 8192, i) for i in range(n)]


def test_same_seed_same_requests():
    a, b = _draw(BIG), _draw(BIG)
    assert all(np.array_equal(p, q) and g == h
               for (p, g), (q, h) in zip(a, b))


def test_other_seed_other_order_same_sizes():
    a, b = _draw(BIG), _draw(7)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    block = MIX["block"]
    for k in range(0, 256, block):
        assert sorted(len(p) for p, _ in a[k:k + block]) == \
            sorted(len(p) for p, _ in b[k:k + block])
        assert sorted(g for _, g in a[k:k + block]) == \
            sorted(g for _, g in b[k:k + block])


def test_inside_the_stated_ranges_and_log_uniform():
    reqs = _draw(3, 640)
    lens = np.array([len(p) for p, _ in reqs])
    new = np.array([g for _, g in reqs])
    lo, hi = MIX["prompt_len"]
    assert lens.min() >= lo and lens.max() <= hi
    assert new.min() >= MIX["new_tokens"][0]
    assert new.max() <= MIX["new_tokens"][1]
    # a log-uniform law's mean is (hi - lo) / ln(hi / lo)
    assert abs(lens.mean() - (hi - lo) / np.log(hi / lo)) < 5
    assert all(p.dtype == np.int32 and p.min() >= 0 and p.max() < 8192
               for p, _ in reqs)


def test_prompts_unique():
    reqs = _draw(5, 512)
    assert len({p[:16].tobytes() for p, _ in reqs}) == 512
