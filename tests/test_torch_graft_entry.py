"""The port's driver hooks (``layoutdetr_tpu_torch.graft_entry``) against the
root ``__graft_entry__.py``: the same example batch bit for bit, the
``entry()`` forward against JAX's ``Generator.apply`` at tiny dims on the
same arrays and converted weights (fp32, 1e-5 max-abs), the two-rank dry
run over gloo on the CPU, and no hidden move to the CPU."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from layoutdetr_tpu.models.generator import Generator as JaxGenerator
from layoutdetr_tpu.models.generator import GeneratorConfig as JaxConfig
from layoutdetr_tpu_torch import graft_entry
from layoutdetr_tpu_torch.config import GeneratorConfig
from layoutdetr_tpu_torch.utils.convert import generator_state_dict_from_jax

from test_torch_common import REPO_ROOT, assert_max_abs, load_port, random_params, tiny_configs
from test_torch_common import one_torch_thread  # noqa: F401 (module-scoped autouse fixture)

TOL = 1e-5
DRYRUN_TIMEOUT_S = 300


def test_example_batch_is_jax_bit_for_bit():
    """The driver's batch at the full config, b=4, T=64: the same draws."""
    want = jax_entry._example_batch(JaxConfig(), b=4, t=64, s=256)
    got = graft_entry._example_batch(GeneratorConfig(), b=4, t=64, s=256)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tensors = graft_entry.to_tensors(got, "cpu")
    assert tensors["text_ids"].dtype == tensors["bbox_class"].dtype == torch.long
    assert tensors["padding_mask"].dtype == torch.bool and tensors["background"].shape == (
        4, 256, 256, 3)


def test_entry_forward_matches_jax_apply():
    """``fn(model, batch)`` of ``entry(device='cpu', cfg=tiny)`` with JAX's
    params crossed over, against ``Generator.apply`` on the same arrays."""
    jcfg, cfg = tiny_configs(bert_max_position_embeddings=64)
    fn, (model, batch) = graft_entry.entry(device="cpu", cfg=cfg)
    assert not model.training and batch["text_ids"].shape == (4, 9, 64)
    arrays = graft_entry._example_batch(cfg, b=4, t=64, s=cfg.background_size)
    params = random_params(JaxGenerator(jcfg), **arrays, reconst=True)
    want = np.asarray(JaxGenerator(jcfg).apply({"params": params}, **arrays))
    load_port(model, generator_state_dict_from_jax(params, cfg))
    got = fn(model, batch)
    assert got.shape == (4, 9, 4) and not got.requires_grad
    assert_max_abs(got, want, TOL, "entry bbox_fake")


def test_dryrun_multichip_two_cpu_ranks():
    """``dryrun_multichip(2, device='cpu')``: two gloo ranks, one step,
    the replica check, and the closing line with step=1 and a finite
    Dreal (in a subprocess with a deadline)."""
    code = ("from layoutdetr_tpu_torch import graft_entry\n"
            "r = graft_entry.dryrun_multichip(2, device='cpu')\n"
            "assert r['backend'] == 'gloo' and [x['step'] for x in r['ranks']] == [1, 1]\n"
            "assert len({x['dreal'] for x in r['ranks']}) == 1\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=DRYRUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    (line,) = [x for x in proc.stdout.splitlines() if x.startswith("dryrun_multichip(2) OK;")]
    assert "grid={'data': 2, 'model': 1}" in line and "backend=gloo" in line
    assert "step=1," in line
    assert np.isfinite(float(line.rsplit("Dreal=", 1)[1]))


def test_dryrun_config_differs_from_jax_in_the_text_encoder_only():
    """The dry run's config is JAX's but for a text encoder the fused
    kernel takes: 192 wide, one head."""
    port = dataclasses.asdict(graft_entry.DRYRUN_CONFIG)
    jax_cfg = dict(hidden_dim=16, bert_f_dim=32, bert_num_heads=2, bert_num_encoder_layers=1,
                   bert_num_decoder_layers=1, im_f_dim=16, max_text_length=16, vocab_size=64,
                   bos_token_id=62, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                   reconst_decoder_layers=1, uncond_encoder_layers=1,
                   backbone_stage_sizes=(1, 1, 1, 1), dim_feedforward=32, background_size=32,
                   max_elements=3)
    want = dataclasses.asdict(GeneratorConfig(**{**jax_cfg, "bert_f_dim": 192,
                                                 "bert_num_heads": 1}))
    assert port == want
    assert port["bert_f_dim"] // port["bert_num_heads"] == 192


@pytest.mark.parametrize("hook", ["entry", "dryrun_multichip"])
def test_hooks_refuse_without_a_card(hook):
    """No CUDA device and no device='cpu': both hooks raise, nothing runs
    on the CPU in their place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry() if hook == "entry" else graft_entry.dryrun_multichip(2)
