"""The plain reference agrees with the port at a tiny size on the CPU: the
dropout keep mask, attention, bias_act, G's forward, and three train steps
as the training cells compare them. The reference itself imports nothing
of the port; only this test holds the two side by side."""

import numpy as np
import pytest
import torch

from tiny import SEED, TINY

from benchmark.harness import common, compare
from benchmark.reference import attention as ref_attention
from benchmark.reference import bias_act as ref_bias_act
from benchmark.reference import train_step as ref
from benchmark.reference.config import GeneratorConfig as RefConfig
from benchmark.traffic import grammar, pages, tokenizer

DRIVERS = f"{common.ROOT}/benchmark/drivers"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_keep_mask_and_attention():
    from layoutdetr_tpu_torch.ops import attention as port

    seed = SEED & 0xFFFFFFFF
    want = port.keep_mask(seed, 3, 2, 37, 0.1)
    assert torch.equal(ref_attention.keep_mask(seed, 3, 2, 37, 0.1), want)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 2, 37, 192, generator=g) for _ in range(3))
    bias = torch.where(torch.arange(37) < 20, 0.0, -10000.0).expand(3, 37).contiguous()
    got = ref_attention.attention(q, k, v, bias, 192 ** -0.5, 0.1, seed)
    assert torch.allclose(got, port.fused_attention(q, k, v, bias, scale=192 ** -0.5,
                                                    dropout_rate=0.1, seed=seed), atol=1e-6)


@pytest.mark.parametrize("act,clamp", [("lrelu", 256.0), ("linear", None)])
def test_bias_act(act, clamp):
    from layoutdetr_tpu_torch.ops import bias_act as port

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 4, 4, generator=g, requires_grad=True)
    b = torch.randn(8, generator=g, requires_grad=True)
    y_ref = ref_bias_act.bias_act(x, b, 1, act, clamp=clamp)
    (gx_ref, gb_ref) = torch.autograd.grad(y_ref.square().sum(), (x, b))
    y = port.bias_act(x, b, 1, act, clamp=clamp)
    (gx, gb) = torch.autograd.grad(y.square().sum(), (x, b))
    for a, w in ((y, y_ref), (gx, gx_ref), (gb, gb_ref)):
        assert torch.allclose(a, w, rtol=1e-6, atol=1e-6)


def test_generator_forward():
    from layoutdetr_tpu_torch.config import GeneratorConfig
    from layoutdetr_tpu_torch.models.generator import Generator

    rG = ref.make_generator(RefConfig(**TINY), SEED, "cpu").eval()
    G = Generator(GeneratorConfig(**TINY)).eval()
    G.load_state_dict(rG.state_dict())
    rng = np.random.default_rng(0)
    texts = [[grammar.layout(rng, 9)[2][0]] * 9 for _ in range(2)]
    ids, mask, lens = tokenizer.encode(texts, 16, 16)
    args = (torch.randn(2, 9, 4), torch.zeros(2, 9, dtype=torch.long), None,
            torch.from_numpy(ids).long(), torch.from_numpy(mask), torch.from_numpy(lens).long(),
            torch.zeros(2, 9, dtype=torch.bool), torch.randn(2, 32, 32, 3))
    with torch.no_grad():
        assert torch.allclose(G(*args), rG(*args), atol=1e-6)


def test_three_train_steps():
    driver = common.load_module(f"{DRIVERS}/train_step.py", "bm_test_train_driver")
    mix = dict(pages=8, batch=2, max_elements=9, logo_p=0.6)
    drawn = pages.draw_pages(mix, SEED, 32, "cpu")
    state, step = driver.build_program(TINY, SEED, "cpu", 2)
    prog = driver.program_checked(state, step, pages.DevicePool(drawn, mix, SEED, 16, 16, "cpu"),
                                  SEED, 3)
    refd = driver.reference_checked(TINY, SEED, "cpu", pages.DevicePool(drawn, mix, SEED, 16, 16,
                                                                        "cpu"), prog["rows"], 2,
                                    programs=[prog])
    gaps = compare.train_gaps(prog, refd)
    assert gaps["loss_gap"][0] < 1e-6 and gaps["grad_gap"][0] < 1e-5
    assert gaps["change_gap"][0] < 1e-5
    assert all(g > 0 for g in refd["change_D"][:5])  # the steps moved D
