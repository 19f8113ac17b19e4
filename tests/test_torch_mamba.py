"""Port parity: the Mamba2 half of ``repro_torch.models.ssm`` against the reference.

The reference's ``init_mamba`` parameters (reduced zamba2-7b: d_model 256,
16 heads of 32, state 16, ``ssd_chunk`` 8) are carried across, and both
packages run the same numpy-seeded inputs in float32: the chunked SSD with
and without its final state at a length that is no multiple of the chunk,
then a chain of decode steps from that state, each within 1e-5 of the
reference's largest output (and state) magnitude.  The port's SSD is also
held to its own per-token recurrence (``mamba_recurrent_ref``) within the
reference's own tolerance for that check (``tests/test_models.py``: rtol
5e-2, atol 5e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

REL_TOL = 1e-5
F32 = torch.float32


def _setup(seed=0):
    ref_cfg = ref_get_config("zamba2-7b").reduced()
    cfg = get_config("zamba2-7b").reduced()
    tree = jax.tree.map(np.asarray, ref_ssm.init_mamba(jax.random.PRNGKey(seed), ref_cfg))
    port = ssm.Mamba(**{k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
    return ref_cfg, cfg, tree, port


def _u(B, S, D, seed):
    return (0.5 * np.random.default_rng(seed).normal(size=(B, S, D))).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("S", [21, 8, 5])
def test_mamba_ssd_matches_reference(S):
    ref_cfg, cfg, tree, port = _setup()
    u = _u(2, S, cfg.d_model, S)
    want = ref_ssm.mamba_ssd(tree, ref_cfg, jnp.asarray(u))
    got = ssm.mamba_ssd(port, cfg, torch.from_numpy(u), F32)
    _close(got.numpy(), want)


def test_mamba_ssd_state_and_decode_chain_match_reference():
    ref_cfg, cfg, tree, port = _setup(seed=1)
    u = _u(2, 19, cfg.d_model, 1)
    want, ref_state = ref_ssm.mamba_ssd(tree, ref_cfg, jnp.asarray(u), return_state=True)
    got, state = ssm.mamba_ssd(port, cfg, torch.from_numpy(u), F32, return_state=True)
    _close(got.numpy(), want)
    _close(state.h.numpy(), ref_state.h)
    _close(state.conv.numpy(), ref_state.conv)
    steps = _u(2, 6, cfg.d_model, 2)
    for t in range(steps.shape[1]):
        want, ref_state = ref_ssm.mamba_decode(tree, ref_cfg, jnp.asarray(steps[:, t:t + 1]),
                                               ref_state)
        got, state = ssm.mamba_decode(port, cfg, torch.from_numpy(steps[:, t:t + 1]), state, F32)
        _close(got.numpy(), want)
        _close(state.h.numpy(), ref_state.h)
        _close(state.conv.numpy(), ref_state.conv)


def test_mamba_recurrent_ref_matches_reference_and_ssd():
    ref_cfg, cfg, tree, port = _setup(seed=2)
    u = _u(2, 13, cfg.d_model, 3)
    want = ref_ssm.mamba_recurrent_ref(tree, ref_cfg, jnp.asarray(u))
    rec = ssm.mamba_recurrent_ref(port, cfg, torch.from_numpy(u), F32)
    _close(rec.numpy(), want)
    ssd = ssm.mamba_ssd(port, cfg, torch.from_numpy(u), F32)
    np.testing.assert_allclose(ssd.numpy(), rec.numpy(), rtol=5e-2, atol=5e-3)


def test_init_mamba_matches_reference_shapes_and_constants():
    ref_cfg, cfg, tree, _ = _setup()
    port = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    for name in ssm.Mamba.NAMES:
        assert tuple(getattr(port, name).shape) == tree[name].shape, name
    for name in ("ln", "conv_b", "A_log", "D_skip", "dt_bias", "out_norm"):
        np.testing.assert_allclose(getattr(port, name).numpy(), tree[name], rtol=1e-6)
    state = ssm.init_mamba_state(cfg, 3, F32, "cpu")
    ref_state = ref_ssm.init_mamba_state(ref_cfg, 3)
    assert state.h.shape == ref_state.h.shape and state.conv.shape == ref_state.conv.shape


def test_ssd_gradients_stay_finite_past_float32s_decay_range():
    """With dt large enough that a chunk's decay from a later step back to
    an earlier one leaves float32's range (dt_bias 30: exp of ~1e4), the
    SSD's outputs are still the reference's and every gradient is finite:
    the port masks the decay's exponent before exp, where the reference's
    exp(+large) of the masked entries gives inf and its gradient NaN."""
    ref_cfg, cfg, tree, port = _setup(seed=2)
    tree = {**tree, "dt_bias": np.full_like(tree["dt_bias"], 30.0)}
    port = ssm.Mamba(**{k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
    u = _u(2, 21, cfg.d_model, 2)
    want = ref_ssm.mamba_ssd(tree, ref_cfg, jnp.asarray(u))
    x = torch.from_numpy(u).requires_grad_()
    for p in port.parameters():
        p.requires_grad_(True)
    got = ssm.mamba_ssd(port, cfg, x, F32)
    _close(got.detach().numpy(), want)
    grads = torch.autograd.grad(got.square().sum(), [x, *port.parameters()], allow_unused=True)
    assert all(bool(torch.isfinite(g).all()) for g in grads if g is not None)   # ln: the block's
