"""The rooflines' operation and byte counts against hand arithmetic."""

from tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)

from benchmark import rooflines
from benchmark.rooflines import attention, bias_act


def test_attention_text_pass_shape():
    # 144 texts x 4 heads x 256 tokens x 192: q k^T and p v, 2 * 144*4*256*256*192 each
    flops, nbytes = attention.cost(dict(shape=(144, 4, 256, 192), itemsize=4))
    assert flops == 4 * 144 * 4 * 256 * 256 * 192 == 28_991_029_248
    # q, k, v, out: 4 x 144*4*256*192 fp32, and the [144, 256] fp32 bias
    assert nbytes == 4 * 144 * 4 * 256 * 192 * 4 + 144 * 256 * 4 == 453_132_288
    seconds, by = rooflines.least_seconds(flops, nbytes, 4)
    assert by == "operations" and abs(seconds - 28991029248 / 67e12) < 1e-15


def test_bias_act_lrelu_map():
    call = dict(shape=(16, 512, 8, 8), itemsize=4, dim=1, act="lrelu", gain=2 ** 0.5, clamp=256.0)
    n = 16 * 512 * 8 * 8
    assert bias_act.forward(call) == (4 * n, 2 * n * 4 + 4 * 512)
    # dy, x read; dx written; b read; fp32 db written
    assert bias_act.backward(call) == (6 * n, 3 * n * 4 + 8 * 512)
    seconds, by = rooflines.least_seconds(*bias_act.forward(call), 4)
    assert by == "bytes" and abs(seconds - (2 * n * 4 + 4 * 512) / 3.35e12) < 1e-18


def test_bias_act_linear_pass_through():
    call = dict(shape=(16, 512), itemsize=4, dim=1, act="linear", gain=1.0, clamp=None)
    # dx is dy itself: dy read, b read, db written
    assert bias_act.backward(call) == (6 * 16 * 512, 16 * 512 * 4 + 8 * 512)
