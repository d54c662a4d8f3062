"""The yardstick's arithmetic against hand-computed values."""
import statistics

import pytest

from portbench import flops, stats
from portbench.arch import Arch


def tiny(**kw):
    base = dict(name="t", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16,
                vocab_size=10, norm="rmsnorm", norm_eps=1e-6, rope_theta=1e4,
                tie_embeddings=False, dtype="bfloat16", init_std=0.02)
    base.update(kw)
    return Arch(**base)


def test_percentile_interpolates():
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    # rank 0.95 * 4 = 3.8: 4 + 0.8 * (10 - 4)
    assert stats.percentile([3, 1, 10, 2, 4], 95) == pytest.approx(8.8)
    assert stats.percentile(list(range(101)), 90) == pytest.approx(90.0)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)
    assert stats.spread([7.0] * 6) == 0.0


def test_layer_weights_dense_and_moe():
    a = tiny()
    # q and o: 8*2*4 each; k and v: 8*1*4 each; MLP 3*8*16
    assert flops.layer_weights(a) == 64 + 64 + 32 + 32 + 384
    m = tiny(n_experts=4, experts_per_tok=2)
    assert flops.layer_weights(m) == 192 + 8 * 4 + 2 * 3 * 8 * 16


def test_decode_and_prefill_flops():
    a = tiny()
    # 2 * (2 layers * 576 + head 8 * 10) + attention 2 layers * 4 * 2 heads * 4 * keys
    assert flops.decode_token_flops(a, 5) == 2 * (2 * 576 + 80) + 2 * 4 * 2 * 4 * 5
    # 3 tokens: weights for each, head once, keys 1 + 2 + 3
    assert flops.prefill_flops(a, 3) == 2 * 3 * 2 * 576 + 2 * 80 + 2 * 4 * 2 * 4 * 6


def test_paged_call_bytes():
    a = tiny()
    # two sequences with 5 and 0 cached tokens, pages of 4 tokens
    kv = 5 * 2 * 1 * 4 * 2           # tokens x (K, V) x KV heads x D x bf16
    table = 2 * 4 + 2 * 4            # ceil(5 / 4) entries and 2 lengths
    q_out = 2 * 2 * 2 * 4 * 2        # q and out: B x H x D x bf16
    lse = 2 * 2 * 4
    assert flops.paged_call_bytes(a, [5, 0], 4) == kv + table + q_out + lse
