"""The LM model zoo (port of ``repro.models``): dense attention and RWKV6
serving on one card; see :mod:`repro_torch.models.lm` for what is ported."""
