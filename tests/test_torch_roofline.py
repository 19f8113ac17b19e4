"""Port parity: ``repro_torch.launch.roofline.model_flops`` against the
reference's ``repro.launch.roofline.model_flops``.

Every configuration at every input shape of ``INPUT_SHAPES`` (train,
prefill and two decodes): the same float arithmetic over the same counts,
so the two are equal (relative 1e-12).  The utilisation divides by an
H100's bfloat16 peak, not the reference's TPU v5e constant.
"""
import pytest

from repro.configs import ARCH_NAMES
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch.roofline import model_flops as ref_model_flops
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch.roofline import PEAK_FLOPS_BF16, model_flop_utilisation, model_flops


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_matches_reference(arch, shape):
    want = ref_model_flops(ref_get_config(arch), REF_SHAPES[shape])
    got = model_flops(get_config(arch), INPUT_SHAPES[shape])
    assert want > 0 and abs(got - want) <= 1e-12 * want


def test_utilisation_is_against_the_h100_bf16_peak():
    """A tinyllama step at batch 4 x 2048 that takes 1 s uses model_flops /
    989e12 of the card: 6 N tokens plus the causal attention term."""
    cfg = get_config("tinyllama-1.1b")
    shape = InputShape("train", 2048, 4, "train")
    n, tokens = cfg.active_param_count(), 4 * 2048
    att = 1.5 * 4.0 * 2048 * 2048 * cfg.n_heads * cfg.resolved_head_dim * 4 * cfg.n_layers
    assert model_flops(cfg, shape) == pytest.approx(6.0 * n * tokens + att, rel=1e-12)
    assert PEAK_FLOPS_BF16 == 989e12
    assert model_flop_utilisation(cfg, shape, 1.0) == pytest.approx(
        model_flops(cfg, shape) / 989e12, rel=1e-12)
