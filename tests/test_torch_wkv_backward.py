"""Port parity: the WKV backward's plain twins and the ``WKV`` autograd Function.

The reference has no WKV backward kernel: it differentiates its recurrence
with ``jax.vjp``.  So the port's gradients are held against ``jax.vjp`` of
the reference's ``wkv_ref`` (all six: dr, dk, dv, dw, du and dstate0, with a
cotangent on the output and on the final state) and of its
``rwkv_time_mix``, on numpy-seeded inputs.

- ``WKV.apply`` on the CPU (the Function's own wiring around
  ``wkv_plain`` / ``wkv_bwd_plain``) within REL_TOL = 1e-5 of each
  gradient's max |value|: both sides step the same recurrence in float32 in
  nearly the same order.
- ``wkv_bwd_chunked_ref`` (the CUDA backward's schedule: chunks, a reverse
  scan over them, the sub-block chunk form) within ATOL + SCALE_RTOL of
  each gradient's max |value|, as ``test_torch_wkv.py`` holds the forward's
  chunked route: its sums run in another order, and in the slow regime the
  state and its gradient sum nearly all of the sequence (values in the
  hundreds at S = 300, where one float32 ulp is ~3e-5).
- Three decay regimes (``test_torch_wkv.py``'s: the model's slow init,
  sigmoid, fast ww ~ U[-6, 2] with w down to ~6e-4), S from 1 to 300 (one
  chunk, ragged chunks), head dims 16 and 32, with and without state0.
- No step divides by w: fast decays with entries of w exactly 0 give finite
  gradients equal to the stepwise twin's within REL_TOL.
- The kernel's 3xTF32 tensor-core products, modelled (``tf32=True``: each
  operand split into hi and lo parts rounded to 10 mantissa bits, lo lo
  dropped), stay within REL_TOL of the stepwise twin in all three regimes,
  w = 0 exactly included.
- The port's ``rwkv_time_mix`` under autograd (the reference's parameters,
  reduced rwkv6) within MIX_REL_TOL = 1e-4 of each leaf's max |g|: the
  per-head group norm divides by each head's spread of the WKV outputs,
  which amplifies the float32 rounding of both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.wkv import wkv_ref as ref_wkv_ref
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.kernels.wkv import (
    WKV,
    wkv,
    wkv_bwd_chunked_ref,
    wkv_bwd_plain,
    wkv_bwd_plan,
    wkv_plain,
)
from repro_torch.kernels.wkv.wkv import CHUNK, CHUNKED_MIN_S
from repro_torch.models import ssm

REL_TOL = 1e-5
ATOL = 2e-5
SCALE_RTOL = 1e-6
MIX_REL_TOL = 1e-4
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


def _decay(rng, shape, regime):
    if regime == "slow":
        w = np.exp(-np.exp(-6.0 + 0.5 * rng.normal(size=shape)))
    elif regime == "fast":
        w = np.exp(-np.exp(rng.uniform(-6.0, 2.0, size=shape)))
    else:
        w = 1.0 / (1.0 + np.exp(-rng.normal(size=shape)))
    return w.astype(np.float32)


def _operands(B, S, H, hd, seed, regime, with_state):
    """r, k, v, w, u, state0 (or None), dout, dstateT as numpy float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = _decay(rng, (B, S, H, hd), regime)
    u = (0.1 * rng.normal(size=(H, hd))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, hd, hd))).astype(np.float32) if with_state else None
    dout = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    dT = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0, dout, dT


def _reference_vjp(r, k, v, w, u, s0, dout, dT):
    """jax.vjp of the reference's wkv_ref -> the six gradients (dstate0 of a
    zero state when s0 is None)."""
    s0 = np.zeros(dT.shape, np.float32) if s0 is None else s0
    _, vjp = jax.vjp(ref_wkv_ref, *(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dout), jnp.asarray(dT)))]


def _function_grads(r, k, v, w, u, s0, dout, dT):
    """The six gradients of WKV.apply on CPU leaves, through autograd."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, w, u)]
    state0 = torch.from_numpy(np.zeros(dT.shape, np.float32) if s0 is None else s0)
    state0.requires_grad_()
    out, stateT = WKV.apply(*leaves, state0)
    torch.autograd.backward((out, stateT), (torch.from_numpy(dout), torch.from_numpy(dT)))
    return [a.grad.numpy() for a in leaves + [state0]]


def _assert_rel(got, want, tol, what):
    for name, a, b in zip(NAMES, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert np.isfinite(a).all(), (what, name)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= tol * scale, (what, name, err, scale)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("S", [1, 7, 16, 47, 64, 129, 300])
@pytest.mark.parametrize("regime", ["slow", "sigmoid", "fast"])
def test_function_and_chunked_ref_match_reference_vjp(regime, S, hd, with_state):
    ops = _operands(2, S, 2, hd, seed=S * 10 + hd + with_state, regime=regime,
                    with_state=with_state)
    want = _reference_vjp(*ops)
    _assert_rel(_function_grads(*ops), want, REL_TOL, "WKV.apply")
    r, k, v, w, u, s0, dout, dT = (None if a is None else torch.from_numpy(a) for a in ops)
    got = wkv_bwd_chunked_ref(r, k, v, w, u, dout, s0, dT)
    for name, a, b in zip(NAMES, got, want):
        assert torch.isfinite(a).all(), name
        err = np.abs(a.numpy() - b).max()
        assert err <= ATOL + SCALE_RTOL * np.abs(b).max(), (name, err, np.abs(b).max())


@pytest.mark.parametrize("S,chunk,sub", [(100, 32, 8), (70, 16, 16), (33, 64, 32)])
def test_chunked_ref_other_tilings_match_stepwise_twin(S, chunk, sub):
    """Chunks shorter than the kernel's, one sub-block a chunk, sub-blocks
    shorter and longer than the kernel's 16 steps: the schedule's
    bookkeeping holds for any tiling."""
    ops = _operands(1, S, 2, 16, seed=S, regime="fast", with_state=True)
    r, k, v, w, u, s0, dout, dT = (torch.from_numpy(a) for a in ops)
    want = wkv_bwd_plain(r, k, v, w, u, dout, s0, dT)
    got = wkv_bwd_chunked_ref(r, k, v, w, u, dout, s0, dT, chunk=chunk, sub=sub)
    _assert_rel(got, [b.numpy() for b in want], REL_TOL, (chunk, sub))


def test_chunked_ref_rejects_bad_tilings():
    r, k, v, w, u, _, dout, _ = (None if a is None else torch.from_numpy(a)
                                 for a in _operands(1, 8, 1, 16, 0, "fast", False))
    with pytest.raises(ValueError, match="multiple"):
        wkv_bwd_chunked_ref(r, k, v, w, u, dout, chunk=24)
    with pytest.raises(ValueError, match="multiple"):
        wkv_bwd_chunked_ref(r, k, v, w, u, dout, chunk=32, sub=0)


@pytest.mark.parametrize("regime", ["slow", "sigmoid", "fast"])
def test_chunked_ref_with_tf32_products_matches_stepwise_twin(regime):
    """The kernel's arithmetic: every product over the head dim or a
    sub-block as 3xTF32 (hi and lo parts rounded to nearest at 10 mantissa
    bits, lo lo dropped), at rwkv6's head dim 64 over two chunks, a ragged
    one last; in the fast regime with decays of exactly 0 (a row reset
    within a sub-block, a whole step at the end)."""
    S = CHUNK + 37
    ops = list(_operands(2, S, 2, 64, seed=23, regime=regime, with_state=True))
    if regime == "fast":
        ops[3][0, S // 2, 0, :5] = 0.0
        ops[3][:, -1] = 0.0
    r, k, v, w, u, s0, dout, dT = (torch.from_numpy(a) for a in ops)
    want = [b.numpy() for b in wkv_bwd_plain(r, k, v, w, u, dout, s0, dT)]
    got = wkv_bwd_chunked_ref(r, k, v, w, u, dout, s0, dT, tf32=True)
    _assert_rel(got, want, REL_TOL, ("tf32", regime))


@pytest.mark.parametrize("S", [5, 40, 150])
def test_decays_of_exactly_zero_give_finite_equal_gradients(S):
    """w = 0 at some steps (a whole state row reset) and fast decays
    elsewhere: a route that divided by w or by a product of w's would give
    0/0 or inf; the chunked schedule and the Function give the stepwise
    twin's gradients."""
    ops = list(_operands(2, S, 2, 16, seed=S + 1, regime="fast", with_state=True))
    w = ops[3]
    w[0, S // 2, 0, :5] = 0.0
    w[1, :, 1, 3] = 0.0
    w[:, -1] = 0.0
    r, k, v, w_t, u, s0, dout, dT = (torch.from_numpy(a) for a in ops)
    want = [a.numpy() for a in wkv_bwd_plain(r, k, v, w_t, u, dout, s0, dT)]
    assert all(np.isfinite(a).all() for a in want)
    assert np.abs(want[3]).max() > 0
    _assert_rel(wkv_bwd_chunked_ref(r, k, v, w_t, u, dout, s0, dT), want, REL_TOL, "chunked")
    _assert_rel(_function_grads(*ops), want, REL_TOL, "WKV.apply")


def test_wkv_under_grad_runs_the_function_and_accepts_unused_outputs():
    """wkv records the WKV Function where autograd records; the backward
    takes None for an output that was not used (the final state's, or the
    output's), and gives u no gradient when u does not require one."""
    ops = _operands(1, 9, 2, 16, seed=3, regime="sigmoid", with_state=True)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in ops[:6])
    r.requires_grad_()
    out, stateT = wkv(r, k, v, w, u, s0)
    assert "WKVBackward" in out.grad_fn.name()
    (grad_out,) = torch.autograd.grad(out.sum(), r)
    want = wkv_bwd_plain(r.detach(), k, v, w, u, torch.ones_like(out), s0)[0]
    torch.testing.assert_close(grad_out, want, rtol=0, atol=0)
    out, stateT = wkv(r, k, v, w, u, s0)
    (grad_state,) = torch.autograd.grad(stateT.sum(), r)
    want = wkv_bwd_plain(r.detach(), k, v, w, u, torch.zeros_like(out), s0,
                         torch.ones_like(stateT))[0]
    torch.testing.assert_close(grad_state, want, rtol=0, atol=0)
    with torch.no_grad():
        out, _ = wkv(r, k, v, w, u, s0)
    assert out.grad_fn is None


def test_gradients_come_back_in_each_operands_dtype():
    """Training's types: r, k, v and u in bfloat16, w and state0 float32."""
    ops = _operands(1, 6, 2, 16, seed=5, regime="slow", with_state=True)
    r, k, v, u = (torch.from_numpy(ops[i]).to(torch.bfloat16).requires_grad_()
                  for i in (0, 1, 2, 4))
    w, s0 = (torch.from_numpy(ops[i]).requires_grad_() for i in (3, 5))
    out, _ = wkv(r, k, v, w, u, s0)
    out.sum().backward()
    for a in (r, k, v, w, u, s0):
        assert a.grad is not None and a.grad.dtype == a.dtype and torch.isfinite(a.grad).all()


def test_bwd_plan_covers_every_length():
    """The backward walks chunks of CHUNK from step 0 at any S: a sequence
    the recurrent forward takes (S < CHUNKED_MIN_S) is one chunk."""
    for S in (1, CHUNKED_MIN_S - 1, CHUNKED_MIN_S, CHUNK, CHUNK + 1, 2048):
        plan = wkv_bwd_plan(S)
        assert plan.chunk == CHUNK and (plan.n_chunks - 1) * CHUNK < S <= plan.n_chunks * CHUNK
    with pytest.raises(ValueError):
        wkv_bwd_plan(0)


def test_chunked_ref_takes_the_forwards_chunk_starts():
    """Given the chunk-start states (as the forward's chunked route keeps
    them) the schedule gives what it gives when it steps them itself."""
    S = 2 * CHUNK + 5
    ops = _operands(1, S, 1, 16, seed=11, regime="sigmoid", with_state=True)
    r, k, v, w, u, s0, dout, dT = (torch.from_numpy(a) for a in ops)
    starts = torch.stack([s0] + [wkv_plain(r[:, :t], k[:, :t], v[:, :t], w[:, :t], u, s0)[1]
                                 for t in (CHUNK, 2 * CHUNK)], dim=2)
    a = wkv_bwd_chunked_ref(r, k, v, w, u, dout, s0, dT, starts=starts)
    b = wkv_bwd_chunked_ref(r, k, v, w, u, dout, s0, dT)
    _assert_rel(a, [x.numpy() for x in b], REL_TOL, "starts")


def _rwkv_params(seed):
    ref_cfg = ref_get_config("rwkv6-1.6b").reduced()
    ref_p = ref_ssm.init_rwkv(jax.random.PRNGKey(seed), ref_cfg)
    port_p = ssm.RWKV(**{k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()})
    return ref_cfg, ref_p, get_config("rwkv6-1.6b").reduced(), port_p


@pytest.mark.parametrize("S,with_state", [(9, False), (9, True), (1, True), (70, False)])
def test_time_mix_gradients_match_reference(S, with_state):
    """Every parameter's gradient, x's and (with a carried state) the
    state's: the port's rwkv_time_mix under autograd against jax.vjp of the
    reference's, the output's and the new WKV state's cotangents seeded."""
    ref_cfg, ref_p, cfg, port_p = _rwkv_params(seed=S)
    B, D = 2, cfg.d_model
    H, hd = ref_ssm.rwkv_dims(ref_cfg)
    rng = np.random.default_rng(S + 7)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    dy = rng.normal(size=(B, S, D)).astype(np.float32)
    st = ((0.1 * rng.normal(size=(B, H, hd, hd))).astype(np.float32),
          rng.normal(size=(B, D)).astype(np.float32),
          rng.normal(size=(B, D)).astype(np.float32)) if with_state else None
    dstate = rng.normal(size=(B, H, hd, hd)).astype(np.float32)

    def ref_fn(p, x, wkv0):
        state = None if wkv0 is None else ref_ssm.RWKVState(wkv0, *map(jnp.asarray, st[1:]))
        out, new = ref_ssm.rwkv_time_mix(p, ref_cfg, x, state)
        return out, (None if new is None else new.wkv)

    wkv0 = None if st is None else jnp.asarray(st[0])
    _, vjp = jax.vjp(ref_fn, ref_p, jnp.asarray(x), wkv0)
    want_p, want_x, want_s = vjp((jnp.asarray(dy), None if st is None else jnp.asarray(dstate)))

    params = dict(port_p.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    s0 = None if st is None else torch.from_numpy(st[0]).requires_grad_()
    state = None if st is None else ssm.RWKVState(s0, *map(torch.from_numpy, st[1:]))
    out, new = ssm.rwkv_time_mix(port_p, cfg, xt, state, torch.float32)
    outputs, cotangents = [out], [torch.from_numpy(dy)]
    if new is not None:
        outputs.append(new.wkv)
        cotangents.append(torch.from_numpy(dstate))
    torch.autograd.backward(outputs, cotangents)

    pairs = [(name, params[name].grad, want_p[name]) for name in params]
    pairs.append(("x", xt.grad, want_x))
    if s0 is not None:
        pairs.append(("state0", s0.grad, want_s))
    for name, got, want in pairs:
        want = np.asarray(want)
        if got is None:   # a parameter of the channel mix: JAX gives it zeros
            assert not want.any(), name
            continue
        assert np.isfinite(got.numpy()).all(), name
        err, scale = np.abs(got.numpy() - want).max(), np.abs(want).max()
        assert err <= MIX_REL_TOL * scale, (name, err, scale)
    for name in ("w_base", "w_A", "w_B", "u"):
        assert params[name].grad.abs().max() > 0, name
