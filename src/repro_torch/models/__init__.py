"""Models (port of ``repro.models``): the LM zoo's serving path for all ten
configurations (:mod:`repro_torch.models.lm`, with attention, MoE and the
Mamba2 / RWKV6 blocks in :mod:`~repro_torch.models.attention`,
:mod:`~repro_torch.models.moe` and :mod:`~repro_torch.models.ssm`), and the
FL experiments' MLP, LeNet-5 and ResNet-9 (:mod:`repro_torch.models.cnn`)."""
