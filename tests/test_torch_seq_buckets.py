"""``config.suggest_seq_buckets``: the JAX package's ladder rule with every
bucket capped at ``max_length``.

The JAX rule's lowest fine bucket is the p5 length rounded up to the
granularity, never capped: lengths all 100 at ``max_length=100``,
granularity 16, give (100, 112); lengths all 3 at ``max_length=4``,
granularity 8, give (4, 8). The port caps it; wherever the JAX rule stays
within ``max_length`` the two ladders are equal.
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from gliclass.c_tpu.config import suggest_seq_buckets as j_suggest
from gliclass.c_tpu_torch.config import suggest_seq_buckets as t_suggest


def _check(lengths, max_length, budget, granularity):
    got = t_suggest(lengths, max_length=max_length, budget=budget, granularity=granularity)
    assert all(b <= max_length for b in got)
    assert list(got) == sorted(set(got)) and got[-1] == max_length
    assert len(got) <= max(2, budget)
    want = j_suggest(lengths, max_length=max_length, budget=budget, granularity=granularity)
    if max(want) <= max_length:
        assert got == want
    return got, want


def test_the_two_cases_the_jax_rule_takes_past_max_length():
    assert _check([100] * 50, 100, 10, 16) == ((100,), (100, 112))
    assert _check([3] * 50, 4, 10, 8) == ((4,), (4, 8))


def test_a_spread_distribution_equals_the_jax_ladder():
    lengths = np.random.default_rng(0).integers(20, 700, size=2000)
    got, want = _check(lengths, 512, 10, 16)
    assert got == want and len(got) == 10


@settings(max_examples=300, deadline=None)
@given(lengths=st.lists(st.integers(1, 1100), min_size=1, max_size=120), max_length=st.integers(1, 1024),
       budget=st.integers(1, 12), granularity=st.integers(1, 80))
def test_no_bucket_above_max_length_and_jax_equal_where_it_stays_within(lengths, max_length, budget, granularity):
    _check(lengths, max_length, budget, granularity)
