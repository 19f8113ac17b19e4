"""Models (port of ``repro.models``): the LM zoo's dense attention and
RWKV6 serving on one card (:mod:`repro_torch.models.lm`), and the FL
experiments' MLP, LeNet-5 and ResNet-9 (:mod:`repro_torch.models.cnn`)."""
