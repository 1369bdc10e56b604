"""The plain references against the port's CPU path at the port's
reduced sizes: the same weights (the benchmark's init, in the port's
layout), the same loss, gradients and logits."""

import pytest
import torch

from perfbench.reference import common as C
from perfbench.tests import tiny
from perfbench.yardstick import tokens

ARCHS = ["internlm2-1.8b", "mamba2-370m"]


def _full_spec(arch):
    import json
    return json.loads((tiny.ROOT / "configs" / f"{arch}.json").read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_ports_layout_at_full_size(arch):
    """Paths, shapes and dtypes of the published configuration's weights
    equal the port's ``init_params`` (on the meta device: no storage)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TM
    from perfbench import bench
    spec = _full_spec(arch)
    ref = bench.family(spec["reference"])
    bench.check_program(ref.program_fields(spec), get_config(arch))
    port = TM.init_params(get_config(arch), None, "meta")
    ours = {p: (shape, dt) for p, shape, dt, _, _ in ref.leaves(spec)}
    got = {p: (tuple(t.shape), t.dtype) for p, t in C.flatten(port)}
    assert ours == got


@pytest.mark.parametrize("arch", ARCHS)
def test_init_repeats_and_lays_out(arch):
    cfg = tiny.program_config(arch, "bfloat16")
    spec = tiny.spec_for(cfg)
    from perfbench import bench
    ref = bench.family(spec["reference"])
    a = C.flatten(ref.init_params(spec, 2**31 + 5, "cpu"))
    b = C.flatten(ref.init_params(spec, 2**31 + 5, "cpu"))
    c = C.flatten(ref.init_params(spec, 2**31 + 6, "cpu"))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert any(not torch.equal(x, y) for (_, x), (_, y) in zip(a, c))
    for path, t in a:
        if path[-1] == "w":
            fan_in = t.shape[0]
            assert abs(float(t.float().std()) * fan_in ** 0.5 - 1) < 0.2


def _cell(arch):
    cfg = tiny.program_config(arch)
    spec = tiny.spec_for(cfg)
    from perfbench import bench
    return cfg, spec, bench.family(spec["reference"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_the_ports(arch):
    from repro_torch.launch import steps
    cfg, spec, ref = _cell(arch)
    params = ref.init_params(spec, 17, "cpu")
    b = tokens.train_batch(17, 1, 2, 32, cfg.vocab_size)
    batch = {k: torch.as_tensor(v) for k, v in b.items()}
    loss, _, grads = steps.value_and_grad(cfg, params, batch)
    flat = C.flatten(params)
    leaves = [t.float().requires_grad_(True) for _, t in flat]
    tree = C.build_tree([(p, t) for (p, _), t in zip(flat, leaves)])
    with C.full_float32():
        rl = ref.loss(spec, tree, batch["tokens"], batch["labels"])
        rg = torch.autograd.grad(rl, leaves)
    assert abs(float(loss) - float(rl.detach())) < 1e-5 * float(rl.detach())
    for (path, g), r in zip(C.flatten(grads), rg):
        scale = max(float(r.norm()), 1e-6)
        assert float((g - r).norm()) < 1e-4 * scale, path


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_equal_the_ports_prefill_and_decode(arch):
    """The reference's full forward over prompt and served tokens gives
    the logits the port's prefill and cached decode gave for them."""
    from repro_torch.models import transformer as TM
    cfg, spec, ref = _cell(arch)
    params = ref.init_params(spec, 3, "cpu")
    prompt = torch.as_tensor(tokens.prompts(3, 0, 2, 16, cfg.vocab_size))
    gen = 4
    with torch.no_grad():
        logits, cache = TM.prefill(cfg, params, prompt,
                                   cache_len=16 + gen)
        seq, got = prompt, [logits]
        for i in range(gen - 1):
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            seq = torch.cat([seq, tok], dim=1)
            logits, cache = TM.decode_step(cfg, params, cache, tok, 16 + i)
            got.append(logits)
    port = torch.stack(got, dim=1)[..., :cfg.vocab_size]
    tree = C.build_tree([(p, t.float()) for p, t in C.flatten(params)])
    with C.full_float32():
        want = ref.logits_at(spec, tree, seq, list(range(15, 15 + gen)))
    assert torch.allclose(port, want, atol=1e-4, rtol=1e-4)


def test_adamw_matches_the_ports():
    from repro_torch.launch import steps
    cfg = tiny.program_config("internlm2-1.8b")
    opt = steps.make_optimizer(cfg, peak_lr=1.5e-3, total_steps=10)
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(64, 8, generator=g),
              "b": torch.randn(5, generator=g)}
    mine = [params["a"].clone(), params["b"].clone()]
    m = [torch.zeros_like(t) for t in mine]
    v = [torch.zeros_like(t) for t in mine]
    state = opt.init(params)
    for step in (1, 2, 3):
        grads = {"a": torch.randn(64, 8, generator=g) * 3,
                 "b": torch.randn(5, generator=g)}
        params, state = opt.update(grads, state, params)
        C.adamw_update(mine, [grads["a"], grads["b"]], m, v,
                       [torch.float32] * 2, step,
                       C.learning_rate(step, 1.5e-3, 10))
        assert torch.allclose(params["a"], mine[0], atol=1e-6)
        assert torch.allclose(params["b"], mine[1], atol=1e-6)
    for step in range(1, 12):
        assert abs(C.learning_rate(step, 1.5e-3, 10)
                   - float(opt.lr(torch.tensor(step)))) < 1e-9


def test_fp8_control_rounds_the_gemms():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    w = torch.randn(32, 16, generator=torch.Generator().manual_seed(2))
    exact = C.gemm(x, w, "fp32")
    low = C.gemm(x, w, "fp8")
    rel = float((low - exact).norm() / exact.norm())
    assert 5e-3 < rel < 0.1
