"""The traffic generator: the same seed gives the same tuples and drift
events; every seed gives as many of each."""
import numpy as np
import pytest

from bench import traffic as TR
from bench.harness import load_cell

SPEC = load_cell("qwen3-8b.dsms-256x256").traffic
BIG = 2 ** 31 + 12345


def _draw(seed, steps=200):
    t = TR.Traffic(SPEC, seed, 50304, 58)
    return ([t.tokens(k) for k in range(steps)],
            [t.drift(k) for k in range(steps)])


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_same_seed_same_traffic(seed):
    a_tok, a_ev = _draw(seed)
    b_tok, b_ev = _draw(seed)
    assert all(np.array_equal(x, y) for x, y in zip(a_tok, b_tok))
    assert a_ev == b_ev


def test_every_seed_gives_the_same_amount_of_work():
    every = SPEC["drift"]["every"]
    for seed in (1, 2, BIG):
        tok, ev = _draw(seed)
        assert all(t.shape == (SPEC["streams"],) and t.dtype == np.int64
                   and t.min() >= 0 and t.max() < 50304 for t in tok)
        for b in range(0, 200, every):
            block = [e for e in ev[b:b + every] if e]
            assert len(block) == 1
            lo, hi = SPEC["drift"]["tasks"]
            f_lo, f_hi = SPEC["drift"]["factor"]
            assert lo <= len(block[0]) <= hi
            assert all(0 <= t < 58 and f_lo <= f <= f_hi
                       for t, f in block[0].items())
    assert not np.array_equal(_draw(1)[0][0], _draw(2)[0][0])


def test_every_seed_gets_the_same_events_in_another_order():
    n = SPEC["drift"]["cycle"] * SPEC["drift"]["every"]

    def events(seed):
        return [e for e in _draw(seed, n)[1] if e]

    a, b = events(1), events(BIG)
    assert len(a) == len(b) == SPEC["drift"]["cycle"]
    assert a != b and a[0] == b[0]
    key = lambda e: sorted(e.items())  # noqa: E731
    assert sorted(a, key=key) == sorted(b, key=key)


def test_sampled_streams():
    spec = dict(SPEC, streams=512, compare_streams=64)
    a = TR.sample_streams(spec, BIG)
    assert np.array_equal(a, TR.sample_streams(spec, BIG))
    assert len(set(a.tolist())) == 64 and a.max() < 512
    assert np.array_equal(TR.sample_streams(dict(spec, compare_streams=512),
                                            BIG), np.arange(512))


def test_warmup_tuples_are_not_the_windows():
    warm = TR.warmup_tokens(SPEC, 5, 50304, 3)
    tok, _ = _draw(5, 3)
    assert not any(np.array_equal(w, t) for w, t in zip(warm, tok))
