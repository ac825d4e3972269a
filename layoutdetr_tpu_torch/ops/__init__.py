"""The port's kernels: ``attention`` (fused_attention, ``csrc/attention.cu``)
and ``bias_act`` (``csrc/bias_act.cu``), built by ``_build``."""


def launch_counts() -> dict:
    """This process's kernel launches so far, by their names in
    ``chip_smoke.py``'s kernels line (each wrapper counts where it
    launches)."""
    from layoutdetr_tpu_torch.ops import attention, bias_act

    return dict(fused_attention=attention.LAUNCHES["fused_attention"],
                fused_attention_dropout=attention.LAUNCHES["fused_attention_dropout"],
                bias_act=bias_act.LAUNCHES["forward"],
                bias_act_backward=bias_act.LAUNCHES["backward"])
