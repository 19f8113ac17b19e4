"""Port parity: the WKV kernel's plain twin and the RWKV6 time/channel mix.

The twin (``wkv_plain``, which the kernel wrapper takes for CPU tensors) is
held against the reference's Pallas kernel (interpret mode) and its oracle
``wkv_ref`` on the cases of ``tests/test_kernels.py``, with and without an
initial state: atol 2e-5.  So is ``wkv_chunked_ref``, the CUDA kernel's
chunked route in plain PyTorch, in three decay regimes (slow: the model's
init, w ~ 0.9975; sigmoid; fast: ww ~ U[-6, 2], w down to ~6e-4, where a
route that divided by cumulative decay would overflow), with sequences
shorter than a chunk and not a multiple of it.  In the slow regime the
state barely decays, so the outputs grow with S (max|out| ~126 at S = 100,
where one float32 ulp is 7.6e-6) and any two summation orders differ by more
than the absolute 2e-5: the port's stepwise twin itself is 4.6e-5 from the
reference there.  The chunked cases are therefore held to ATOL plus
SCALE_RTOL of the largest |value| (a few float32 ulps of it).  The port's ``rwkv_time_mix`` and
``rwkv_channel_mix`` are held against the reference's with the reference's
own parameters, in prefill and in decode (S = 1, carried state).
``wkv_recurrent_ref`` steps the recurrence as the recurrent CUDA kernel
(decode) does, with its split of each state over 16 row groups of 4-column
threads and its order of the ``out[j]`` sum; it is held to ATOL against the
reference's Pallas kernel at S = 1 with a carried state and at small S, at
every head dim the kernel takes.  Inputs are numpy-seeded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.wkv import wkv as ref_wkv
from repro.kernels.wkv import wkv_ref as ref_wkv_ref
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.kernels.wkv import (
    wkv,
    wkv_chunked_ref,
    wkv_cuda,
    wkv_plain,
    wkv_recurrent_ref,
    wkv_ref,
)
from repro_torch.kernels.wkv.wkv import CHUNK
from repro_torch.models import ssm

ATOL = 2e-5
SCALE_RTOL = 1e-6
MIX_ATOL = 1e-5


def _decay(rng, shape, regime):
    """w in (0, 1): "sigmoid" of a normal, "slow" exp(-exp(-6 + noise)) (the
    model's init), "fast" exp(-exp(ww)) with ww ~ U[-6, 2] (down to ~6e-4)."""
    if regime == "slow":
        w = np.exp(-np.exp(-6.0 + 0.5 * rng.normal(size=shape)))
    elif regime == "fast":
        w = np.exp(-np.exp(rng.uniform(-6.0, 2.0, size=shape)))
    else:
        w = 1.0 / (1.0 + np.exp(-rng.normal(size=shape)))
    return w.astype(np.float32)


def _operands(B, S, H, hd, seed, with_state, regime="sigmoid"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = _decay(rng, (B, S, H, hd), regime)
    u = (0.1 * rng.normal(size=(H, hd))).astype(np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32) if with_state else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,hd", [(2, 16, 4, 16), (1, 40, 2, 32), (3, 7, 1, 16),
                                      (2, 12, 2, 16)])
def test_plain_matches_pallas_and_oracle(B, S, H, hd, with_state):
    ops = _operands(B, S, H, hd, seed=B * 100 + S, with_state=with_state)
    j = [None if a is None else jnp.asarray(a) for a in ops]
    o_pallas, s_pallas = ref_wkv(*j)
    o_oracle, s_oracle = ref_wkv_ref(*j)
    t = [None if a is None else torch.from_numpy(a) for a in ops]
    out, state = wkv(*t)
    for want_o, want_s in ((o_pallas, s_pallas), (o_oracle, s_oracle)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_o), atol=ATOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(want_s), atol=ATOL)
    o2, s2 = wkv_ref(*t)
    assert torch.equal(o2, out) and torch.equal(s2, state)


# (B, S, H, hd): decode (S = 1) at rwkv6-1.6b's heads and at every head dim
# (1 to 8 rows a thread, 1 to 8 blocks a state), and short sequences
RECURRENT_SHAPES = [(4, 1, 32, 64), (2, 1, 3, 16), (2, 1, 3, 32), (1, 1, 2, 128),
                    (2, 7, 2, 64), (1, 12, 2, 32), (2, 5, 1, 128), (3, 16, 2, 16)]


@pytest.mark.parametrize("regime", ["slow", "fast"])
@pytest.mark.parametrize("B,S,H,hd", RECURRENT_SHAPES)
def test_recurrent_ref_matches_pallas_with_carried_state(B, S, H, hd, regime):
    ops = _operands(B, S, H, hd, seed=B * 10 + S + hd, with_state=True, regime=regime)
    want_o, want_s = ref_wkv(*(jnp.asarray(a) for a in ops))
    out, state = wkv_recurrent_ref(*(torch.from_numpy(a) for a in ops))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), atol=ATOL)


@pytest.mark.parametrize("B,S,H,hd", [(2, 3, 2, 64), (1, 1, 2, 16)])
def test_recurrent_ref_from_a_zero_state(B, S, H, hd):
    ops = _operands(B, S, H, hd, seed=S + hd, with_state=False)
    want_o, want_s = ref_wkv(*(None if a is None else jnp.asarray(a) for a in ops))
    out, state = wkv_recurrent_ref(*(None if a is None else torch.from_numpy(a) for a in ops))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), atol=ATOL)


def _assert_close_to_scale(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= ATOL + SCALE_RTOL * np.abs(want).max(), (err, np.abs(want).max())


# (B, S, H, hd, chunk): S shorter than a chunk, not a multiple of it, a
# multiple of it, chunks of one sub-block, and the kernel's chunk length
CHUNKED_SHAPES = [(2, 7, 2, 16, 64), (1, 100, 2, 16, 32), (2, 64, 2, 32, 64),
                  (1, 40, 3, 16, 16), (1, 200, 2, 16, CHUNK)]


@pytest.mark.parametrize("regime", ["slow", "sigmoid", "fast"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,hd,chunk", CHUNKED_SHAPES)
def test_chunked_ref_matches_pallas_and_oracle(B, S, H, hd, chunk, with_state, regime):
    ops = _operands(B, S, H, hd, seed=B * 100 + S + chunk, with_state=with_state,
                    regime=regime)
    j = [None if a is None else jnp.asarray(a) for a in ops]
    t = [None if a is None else torch.from_numpy(a) for a in ops]
    out, state = wkv_chunked_ref(*t, chunk=chunk)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    for want_o, want_s in (ref_wkv(*j), ref_wkv_ref(*j)):
        _assert_close_to_scale(out, want_o)
        _assert_close_to_scale(state, want_s)


@pytest.mark.parametrize("regime", ["slow", "fast"])
def test_chunked_ref_long_sequence_matches_oracle(regime):
    """Chunks of the kernel's length (the default), the last ragged, from a
    carried state."""
    ops = _operands(2, 300, 2, 32, seed=7, with_state=True, regime=regime)
    want_o, want_s = ref_wkv_ref(*(jnp.asarray(a) for a in ops))
    out, state = wkv_chunked_ref(*(torch.from_numpy(a) for a in ops))
    _assert_close_to_scale(out, want_o)
    _assert_close_to_scale(state, want_s)


def test_chunked_ref_rejects_bad_chunks():
    t = [torch.from_numpy(a) for a in _operands(1, 8, 1, 16, 0, False)[:5]]
    with pytest.raises(ValueError, match="multiple"):
        wkv_chunked_ref(*t, chunk=24)


def test_split_sequence_carries_state():
    """Prefill then decode steps with the carried state == one long call."""
    r, k, v, w, u, _ = (None if a is None else torch.from_numpy(a)
                        for a in _operands(2, 10, 3, 16, seed=4, with_state=False))
    whole_o, whole_s = wkv_plain(r, k, v, w, u)
    o, s = wkv_plain(r[:, :7], k[:, :7], v[:, :7], w[:, :7], u)
    outs = [o]
    for t in range(7, 10):
        o, s = wkv_plain(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], w[:, t:t + 1], u, s)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole_o.numpy(), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), whole_s.numpy(), atol=1e-6)


def _rwkv_params(seed=0):
    ref_cfg = ref_get_config("rwkv6-1.6b").reduced()
    ref_p = ref_ssm.init_rwkv(jax.random.PRNGKey(seed), ref_cfg)
    port_p = ssm.RWKV(**{k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()})
    return ref_cfg, ref_p, get_config("rwkv6-1.6b").reduced(), port_p


def _state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    H, hd = ref_ssm.rwkv_dims(cfg)
    return (0.1 * rng.normal(size=(B, H, hd, hd)).astype(np.float32),
            rng.normal(size=(B, cfg.d_model)).astype(np.float32),
            rng.normal(size=(B, cfg.d_model)).astype(np.float32))


@pytest.mark.parametrize("S,with_state", [(9, False), (9, True), (1, True)])
def test_time_and_channel_mix_match_reference(S, with_state):
    ref_cfg, ref_p, cfg, port_p = _rwkv_params(seed=S)
    B = 2
    x = np.random.default_rng(S).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    st = _state(cfg, B, seed=S + 1) if with_state else None
    ref_state = None if st is None else ref_ssm.RWKVState(*(jnp.asarray(a) for a in st))
    port_state = None if st is None else ssm.RWKVState(*(torch.from_numpy(a) for a in st))

    want, want_state = ref_ssm.rwkv_time_mix(ref_p, ref_cfg, jnp.asarray(x), ref_state)
    with torch.inference_mode():
        got, got_state = ssm.rwkv_time_mix(port_p, cfg, torch.from_numpy(x), port_state,
                                           torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MIX_ATOL)
    if with_state:
        for g, w_ in zip(got_state, want_state):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=MIX_ATOL)
    else:
        assert got_state is None and want_state is None

    want_c, want_cs = ref_ssm.rwkv_channel_mix(ref_p, ref_cfg, jnp.asarray(x), ref_state)
    with torch.inference_mode():
        got_c, got_cs = ssm.rwkv_channel_mix(port_p, cfg, torch.from_numpy(x), port_state,
                                             torch.float32)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=MIX_ATOL)
    if with_state:
        np.testing.assert_allclose(got_cs.x_cm.numpy(), np.asarray(want_cs.x_cm), atol=MIX_ATOL)


def test_init_rwkv_state_matches_reference():
    ref_cfg, _, cfg, _ = _rwkv_params()
    want = ref_ssm.init_rwkv_state(ref_cfg, 3)
    got = ssm.init_rwkv_state(cfg, 3, "cpu")
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape and g.dtype == torch.float32 and not g.any()


def test_operand_checks():
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _operands(1, 3, 2, 16, 0, True))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_cuda(r, k, v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="state0 must be"):
        wkv(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="one"):
        wkv(r, k[:, :2], v, w, u)
    with pytest.raises(ValueError, match="RWKV takes exactly"):
        ssm.RWKV(u=u)
