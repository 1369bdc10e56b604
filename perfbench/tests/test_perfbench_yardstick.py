"""The frozen yardsticks: the kernels' work formulas equal the port's
today, the model-FLOP formulas a hand count, and the seeded inputs repeat
exactly."""

import itertools

import numpy as np
import pytest

from perfbench.reference import mamba2, transformer
from perfbench.tests import tiny
from perfbench.yardstick import cost, tokens

FLASH = [(1, 16, 8, 16384, 16384, 128, True, None),
         (8, 16, 8, 8192, 8192, 128, True, None),
         (4, 16, 1, 4096, 4096, 256, True, 2048),
         (8, 12, 12, 1500, 1500, 64, False, None),
         (8, 12, 12, 224, 1500, 64, False, None)]
SSD = [(16, 2048, 32, 64, 128, 256), (8, 4096, 32, 64, 128, 256),
       (2, 1024, 8, 48, 64, 64)]


@pytest.mark.parametrize("shape", FLASH)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_flash_costs_equal_the_ports(shape, itemsize):
    from repro_torch.kernels import cost as port
    for lse in (False, True):
        assert cost.flash_attention_cost(*shape, itemsize, lse=lse) == \
            port.flash_attention_cost(*shape, itemsize, lse=lse)
    assert cost.flash_attention_bwd_cost(*shape, itemsize) == \
        port.flash_attention_bwd_cost(*shape, itemsize)


@pytest.mark.parametrize("shape", SSD)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_ssd_costs_equal_the_ports(shape, itemsize):
    from repro_torch.kernels import cost as port
    assert cost.ssd_scan_cost(*shape, itemsize) == \
        port.ssd_scan_cost(*shape, itemsize)
    assert cost.ssd_scan_bwd_cost(*shape, itemsize) == \
        port.ssd_scan_bwd_cost(*shape, itemsize)


def _spec(name):
    import json
    return json.loads((tiny.ROOT / "configs" / f"{name}.json").read_text())


def test_internlm2_flops_by_hand():
    spec = _spec("internlm2-1.8b")
    D, F, V, S = 2048, 8192, 92544, 16384
    per_layer = 2 * D * D + 2 * D * 1024 + 3 * D * F    # q, o; k, v; ffn
    pairs = S * (S + 1) // 2
    fwd = 24 * (2 * per_layer * S + 4 * 128 * 16 * pairs) + 2 * D * V * S
    assert transformer.train_flops(spec, 1, S) == 3 * fwd
    # ~15 GFLOP a token at 16k
    assert 14.5e9 < 3 * fwd / S < 15.5e9
    # a prefill: the head at the last position only
    P = 8192
    assert transformer.forward_flops(spec, 8, P, 1) == 8 * (
        24 * (2 * per_layer * P + 4 * 128 * 16 * P * (P + 1) // 2)
        + 2 * D * V)


def test_mamba2_flops_by_hand():
    spec = _spec("mamba2-370m")
    D, di, N, H, P, L, V = 1024, 2048, 128, 32, 64, 256, 50280
    T, B = 2048, 16
    proj = D * (2 * di + 2 * N + H) + di * D
    nc, tri = T // L, L * (L + 1) / 2
    scan = 2 * (B * nc * tri * N + B * H * nc * (tri * P + 2 * L * N * P))
    fwd = 48 * (2 * proj * B * T + scan) + 2 * D * V * B * T
    assert mamba2.train_flops(spec, B, T) == 3 * fwd
    assert 2.3e9 < 3 * fwd / (B * T) < 2.6e9


def test_tokens_repeat_and_differ():
    a = tokens.train_batch(2**31 + 7, 4, 2, 16, 1000)
    b = tokens.train_batch(2**31 + 7, 4, 2, 16, 1000)
    c = tokens.train_batch(2**31 + 7, 5, 2, 16, 1000)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].dtype == np.int32 and a["tokens"].max() < 1000
    p = tokens.prompts(-3, 0, 2, 8, 50)
    assert np.array_equal(p, tokens.prompts(-3, 0, 2, 8, 50))
    assert not np.array_equal(p, tokens.prompts(-3, 1, 2, 8, 50))


@pytest.mark.parametrize("n, k", list(itertools.product([1, 5, 40], [1, 3])))
def test_sample_holds_the_last_request(n, k):
    s = tokens.sample(99, n, k)
    assert len(s) == min(n, k) and s[-1] == n - 1
    assert len(set(s.tolist())) == len(s) and s.min() >= 0
