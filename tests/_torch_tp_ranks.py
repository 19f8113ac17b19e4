"""Rank functions of tests/test_torch_tp_serve.py and tests/test_torch_sharded_train.py.

Each runs inside one rank process of ``repro_torch.launch.mesh.run_ranks``
(gloo on the CPU) and imports torch and the port only, never jax: the
reference's results are computed in the test process and the ranks' are
compared with them there.
"""
import dataclasses

import torch

from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.convert import lm_shard_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.mesh import axis_coords, make_mesh
from repro_torch.models import lm


def config(arch: str, experts=None):
    """``arch`` at ``reduced()`` size, with ``experts`` experts if given."""
    cfg = get_config(arch).reduced()
    return cfg if experts is None else dataclasses.replace(cfg, n_experts=experts)


def _greedy(params, batch: dict, n_decode: int) -> dict:
    """Prefill, then ``n_decode`` greedy steps: every step's last-position
    logits (1 + n_decode, B, vocab_padded) and the tokens fed (B, n_decode)."""
    tokens = batch.pop("tokens")
    S = tokens.shape[1]
    prefill = lm.make_prefill_step(S + n_decode)
    step = lm.make_serve_step()
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": tokens, **batch})
        seen, fed = [logits], []
        for t in range(n_decode):
            tok = logits.argmax(-1)[:, None]
            fed.append(tok)
            logits, cache = step(params, cache, tok, S + t)
            seen.append(logits)
    return {"logits": torch.stack(seen), "tokens": torch.cat(fed, dim=1)}


def serve_cases(data: int, model: int, cases: list, n_decode: int) -> dict:
    """On a ``data x model`` mesh: for each case (label, arch, experts,
    scheme, reference numpy tree, prompt, extra inputs) the rank's shard of
    the reference's weights serves its data group's rows; also, on a
    sharded model, whether train mode gives finite logits through a graph
    autograd recorded.  Returns the rank's coordinates and each case's
    :func:`_greedy` record."""
    torch.set_num_threads(1)   # small models; the ranks share the CPU
    mesh = make_mesh(data, model, device_type="cpu")
    out = {"coords": axis_coords(mesh)}
    for label, arch, experts, scheme, tree, prompt, extras in cases:
        cfg = config(arch, experts)
        params = lm_shard_from_numpy(cfg, tree, sharding.plan_for(cfg, scheme), mesh,
                                     device="cpu")
        batch = {"tokens": torch.from_numpy(prompt).long(),
                 **{k: torch.from_numpy(v) for k, v in extras.items()}}
        key = (label, scheme)
        out[key] = _greedy(params, sharding.local_batch(cfg, batch, mesh), n_decode)
        if params.model_axis is not None:
            for p in params.parameters():
                p.requires_grad_(True)
            logits, _ = lm.forward(params, batch["tokens"], mode="train",
                                   vision_embeds=batch.get("vision_embeds"),
                                   encoder_frames=batch.get("encoder_frames"))
            out[key]["train_graph"] = (bool(torch.isfinite(logits).all())
                                       and logits.grad_fn is not None)
            for p in params.parameters():
                p.requires_grad_(False)
    return out


def init_cases(data: int, model: int, cases: list) -> dict:
    """On a ``data x model`` mesh: for each case (label, arch, experts,
    scheme, dtype) the rank's ``init_params_sharded`` parameters (seed 3),
    and whether ``shard_params`` of the unsharded init equals them bit for
    bit."""
    torch.set_num_threads(1)
    mesh = make_mesh(data, model, device_type="cpu")
    out = {"coords": axis_coords(mesh)}
    for label, arch, experts, scheme, dtype in cases:
        cfg = config(arch, experts)
        plan = sharding.plan_for(cfg, scheme)
        got = sharding.init_params_sharded(cfg, plan, mesh, seed=3, dtype=dtype, device="cpu")
        full = lm.init_params(cfg, seed=3, dtype=dtype, device="cpu")
        cut = dict(sharding.shard_params(full, plan, mesh).named_parameters())
        named = dict(got.named_parameters())
        out[label] = {
            "params": {n: p.detach().clone() for n, p in named.items()},
            "shard_params_equal": set(cut) == set(named) and all(
                cut[n].dtype == p.dtype and torch.equal(cut[n], p) for n, p in named.items()),
        }
    return out


def cli(argv: list) -> dict:
    """``repro_torch.launch.serve.main(argv)`` on this rank."""
    torch.set_num_threads(1)
    return serve.main(argv)


def card_case(arch: str, experts, data: int, model: int, batch: int, prompt: int,
              n_decode: int, dtype: torch.dtype) -> dict:
    """On the card this rank was given (ranks may share it over gloo): the
    rank's ``init_params_sharded`` shard (seed 3) of ``arch`` at reduced
    size in ``dtype`` serves a seeded prompt under ``float32_math``; its
    :func:`_greedy` record and the flash launches of the run."""
    from repro_torch._device import float32_math
    from repro_torch.kernels import _build

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = config(arch, experts)
    mesh = make_mesh(data, model, device_type="cuda")
    params = sharding.init_params_sharded(cfg, sharding.plan_for(cfg, "tp_only"), mesh, seed=3,
                                          dtype=dtype, device=device)
    tokens = serve.random_prompt(cfg, batch, prompt, seed=0, device=device)
    _build.reset_launches()
    with float32_math():
        out = _greedy(params, sharding.local_batch(cfg, {"tokens": tokens}, mesh), n_decode)
    return {"logits": out["logits"].cpu(), "tokens": out["tokens"].cpu(),
            "launches": dict(_build.LAUNCHES), "coords": axis_coords(mesh)}


def train_cases(data: int, model: int, cases: list) -> dict:
    """On a ``data x model`` mesh: for each case (key, arch, experts,
    scheme, reference numpy tree, numpy batch, microbatches, the reference
    optimizer's numpy init state) the rank's shard of the reference's
    weights takes ``lm.value_and_grad`` over its rows, then one
    ``make_train_step`` of AdamW under ``cosine_schedule(5e-5, warmup=10,
    total=100)`` with weight decay 0.1 (the LM tests' ``adamw_cosine``),
    its state the reference's cut by ``opt_state_shard_from_numpy``.
    Returns the rank's coordinates and, by case, the loss, the gradient
    pieces, the step's loss, and the parameters and AdamW moments after it."""
    from repro_torch.convert import opt_state_shard_from_numpy
    from repro_torch.optim import adamw, cosine_schedule

    torch.set_num_threads(1)
    mesh = make_mesh(data, model, device_type="cpu")
    out = {"coords": axis_coords(mesh)}
    for key, arch, experts, scheme, tree, batch, microbatches, state in cases:
        cfg = config(arch, experts)
        plan = sharding.plan_for(cfg, scheme)
        params = lm_shard_from_numpy(cfg, tree, plan, mesh, device="cpu")
        batch = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
                 for k, v in batch.items()}
        local = sharding.local_batch(cfg, batch, mesh, microbatches=microbatches)
        loss, grads = lm.value_and_grad(params, local, microbatches=microbatches)
        opt = adamw(cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)
        step = lm.make_train_step(opt, microbatches=microbatches)
        params, state, metrics = step(params, opt_state_shard_from_numpy(cfg, state, plan, mesh,
                                                                         device="cpu"), local)
        out[key] = {"loss": loss, "grads": grads, "step_loss": metrics["loss"],
                    "params": {n: p.detach().clone() for n, p in params.named_parameters()},
                    "m": state["m"], "v": state["v"], "step": state["step"]}
    return out


def train_cli(argv: list) -> list:
    """``repro_torch.launch.train.main(argv)`` on this rank: its losses."""
    from repro_torch.launch import train

    torch.set_num_threads(1)
    return train.main(argv)


def assemble(cfg, plan: dict, results: list, key, field: str) -> tuple[dict, bool]:
    """({name: tensor}, same): each leaf put together from the ranks'
    pieces (``results[r][key][field]``, keyed by parameter name, beside
    ``results[r]["coords"]``; a Mamba2 leaf's by its components, an
    attention leaf's by head, ``sharding.model_parts``), and whether every
    two ranks holding the same piece (the same runs of the leaf: a KV head
    a replica group shares too) hold it bit for bit."""
    full = {n: torch.zeros(p.shape) for n, p in
            lm.init_params(cfg, dtype=torch.float32, device="meta").named_parameters()}
    seen, same = {}, True
    for res in results:
        coords = res["coords"]
        for name, piece in res[key][field].items():
            spec, parts = plan[name], sharding.model_parts(cfg, name)
            at = tuple(tuple(sharding._ranges(d, e, coords, parts))
                       for d, e in zip(full[name].shape, spec))
            first = seen.setdefault((name, at), piece)
            same = same and torch.equal(first, piece)
            sharding.place_slice(full[name], piece, spec, coords, parts)
    return full, same


def first_step_windows(opt, start: dict, grads: dict, delta: dict) -> dict:
    """{name: {"p": (lo, hi), "v": (lo, hi), "open": n}}: where one step
    of AdamW ``opt`` from zero moments puts each parameter of ``start``,
    and its second moment, when the gradient lies within ``delta[name]``
    (absolute) of ``grads[name]``; ``open`` counts the elements with
    |g| <= delta, whose sign the window leaves open.  From zero moments the
    update is monotone in g and v grows with |g|, so the steps of the
    window's ends bound both, each end widened by the rounding of either
    side (two float32 ulps, and 1e-11 absolute for the update's own).  A
    parameter's window is about 2 lr wide where the sign is open, and
    lr * eps * delta / g**2 wide elsewhere: far below lr."""
    from repro_torch.optim import apply_updates

    def step(grads):   # every leaf at once, from zero moments
        zero = {n: torch.zeros((), dtype=torch.float32, device=p.device).expand(p.shape)
                for n, p in start.items()}
        state = {"step": torch.zeros((), dtype=torch.int32,
                                     device=next(iter(start.values())).device),
                 "m": zero, "v": zero}
        updates, state = opt.update(grads, state, start)
        return apply_updates(start, updates), state["v"]

    def widen(a, b, floor):
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        pad = torch.maximum(lo.abs(), hi.abs()) * 2.0 ** -22 + floor
        return lo - pad, hi + pad

    g = {n: t.float() for n, t in grads.items()}
    p_lo, _ = step({n: t - delta[n] for n, t in g.items()})
    p_hi, _ = step({n: t + delta[n] for n, t in g.items()})
    _, v_lo = step({n: (t.abs() - delta[n]).clamp(min=0.0) for n, t in g.items()})
    _, v_hi = step({n: t.abs() + delta[n] for n, t in g.items()})
    return {n: {"p": widen(p_lo[n], p_hi[n], 1e-11), "v": widen(v_lo[n], v_hi[n], 0.0),
                "open": int((g[n].abs() <= delta[n]).sum())} for n in start}


def outside(x: torch.Tensor, window: tuple) -> float:
    """How far the farthest element of ``x`` lies outside ``window``
    (lo, hi), 0 where every one lies inside."""
    lo, hi = window
    if x.numel() == 0:
        return 0.0
    return max(float((lo - x).clamp(min=0.0).max()), float((x - hi).clamp(min=0.0).max()), 0.0)


def card_train_case(arch: str, experts, data: int, model: int, scheme: str, batch: int,
                    seq: int, compute_dtype: torch.dtype = torch.float32) -> dict:
    """On the card this rank was given (ranks may share it over gloo): the
    rank's ``init_params_sharded`` shard (seed 3, float32 masters computing
    in ``compute_dtype``) of ``arch`` at reduced size takes
    ``lm.value_and_grad`` and one step of the LM tests' ``adamw_cosine`` on
    its rows of a seeded batch, under ``float32_math``; the loss, the
    gradient and parameter pieces (on the CPU) and the kernel launches of
    the step."""
    from repro_torch._device import float32_math
    from repro_torch.kernels import _build
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.optim import adamw, cosine_schedule

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = config(arch, experts)
    mesh = make_mesh(data, model, device_type="cuda")
    plan = sharding.plan_for(cfg, scheme)
    params = sharding.init_params_sharded(cfg, plan, mesh, seed=3, dtype=torch.float32,
                                          compute_dtype=compute_dtype, device=device)
    full = synthetic_batch(cfg, batch, seq, torch.Generator(device=device).manual_seed(3),
                           compute_dtype)
    local = sharding.local_batch(cfg, full, mesh)
    opt = adamw(cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)
    with float32_math():
        loss, grads = lm.value_and_grad(params, local)
        _build.reset_launches()
        params, _, metrics = lm.make_train_step(opt)(params, opt.init(dict(
            params.named_parameters())), local)
        launches = dict(_build.LAUNCHES)
    cpu = {n: g.cpu() for n, g in grads.items()}
    return {"coords": axis_coords(mesh), "launches": launches, "case": {
        "loss": loss.cpu(), "step_loss": metrics["loss"].cpu(), "grads": cpu,
        "params": {n: p.detach().cpu() for n, p in params.named_parameters()}}}


def collectives_case(device_type: str = "cpu") -> dict:
    """On a 1 x world mesh over tensors on ``device_type`` (this rank's
    card for ``"cuda"``): ``MeshAxis.gather`` along dims 0 and 1 of a
    rank-seeded piece (``all_gather_into_tensor``) and the backward's
    reduce-scatter of a rank-seeded gradient (``reduce_scatter_tensor``);
    and ``copy``, ``reduce`` and ``sum`` with their gradients.  Every
    tensor comes back on the CPU."""
    import torch.distributed as dist

    from repro_torch.models.layers import MeshAxis

    torch.set_num_threads(1)
    mesh = make_mesh(1, dist.get_world_size(), device_type=device_type)
    i, n = axis_coords(mesh)["model"]
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    gen = torch.Generator().manual_seed(i)

    def draw(shape):
        return torch.randn(shape, generator=gen).to(device)

    axis = MeshAxis(mesh.get_group("model"), n, i)
    out = {}
    for dim in (0, 1):
        piece = draw((3, 4, 5)).requires_grad_()
        whole = axis.gather(piece, dim)
        g = draw(whole.shape)
        (grad,) = torch.autograd.grad(whole, piece, g)
        out[dim] = {"piece": piece.detach(), "whole": whole.detach(), "g": g, "grad": grad}
    x = draw((2, 3)).requires_grad_()
    (dx,) = torch.autograd.grad(axis.copy(x), x, torch.full((2, 3), float(i + 1), device=device))
    y = x.detach().clone().requires_grad_()
    r = axis.reduce(y * 1)
    (dy,) = torch.autograd.grad(r, y, torch.ones(2, 3, device=device))
    z = x.detach().clone().requires_grad_()
    s = axis.sum(z)
    (dz,) = torch.autograd.grad(s, z, torch.full((2, 3), float(i + 1), device=device))
    out["small"] = {"x": x.detach(), "dx": dx, "reduce": r.detach(), "dy": dy,
                    "sum": s.detach(), "dz": dz}
    whole, labels = vocab_parallel_inputs(n)
    V_l = whole.shape[-1] // n
    logits = whole[..., i * V_l:(i + 1) * V_l].to(device).requires_grad_()
    loss = lm.cross_entropy(logits, labels.to(device), axis).mean()
    (dlogits,) = torch.autograd.grad(loss, logits)
    out["vocab"] = {"loss": loss.detach(), "grad": dlogits}
    return {k: {f: t.cpu() for f, t in v.items()} for k, v in out.items()}


def vocab_parallel_inputs(n: int, V_l: int = 7) -> tuple:
    """Seeded float32 logits (2, 9, n * V_l), the same on every rank, and
    labels (2, 9) that hit the first and the last column of every rank's
    range (the rest drawn)."""
    gen = torch.Generator().manual_seed(100)
    whole = 3 * torch.randn((2, 9, n * V_l), generator=gen)
    labels = torch.randint(0, n * V_l, (18,), generator=gen)
    edges = torch.tensor([c for r in range(n) for c in (r * V_l, r * V_l + V_l - 1)])
    labels[:len(edges)] = edges
    return whole, labels[torch.randperm(18, generator=gen)].reshape(2, 9)


def check_collectives(out: list, dim: int) -> None:
    """Asserts on every rank's :func:`collectives_case`: the gather along
    ``dim`` puts the pieces together in rank order and its backward sums the
    gradient and keeps the rank's piece; ``copy`` sums the gradient,
    ``reduce`` the value, ``sum`` both; ``lm.cross_entropy`` over the ranks'
    vocab-parallel columns gives ``F.cross_entropy``'s loss on the whole
    logits (1e-6 relative, the same bits on every rank) and each rank its
    columns of the gradient (within 1e-6 of their largest)."""
    n = len(out)
    whole = torch.cat([res[dim]["piece"] for res in out], dim=dim)
    g = sum(res[dim]["g"] for res in out)
    width = out[0][dim]["piece"].shape[dim]
    for r, res in enumerate(out):
        assert torch.equal(res[dim]["whole"], whole)
        assert torch.allclose(res[dim]["grad"], g.narrow(dim, r * width, width))
    x = sum(res["small"]["x"] for res in out)
    ranks_sum = torch.full((2, 3), float(n * (n + 1) // 2))   # 1 + 2 + ... + n
    for res in out:
        small = res["small"]
        assert torch.equal(small["dx"], ranks_sum)
        assert torch.allclose(small["reduce"], x) and torch.equal(small["dy"], torch.ones(2, 3))
        assert torch.allclose(small["sum"], x) and torch.equal(small["dz"], ranks_sum)
    whole, labels = vocab_parallel_inputs(n)
    whole.requires_grad_()
    want = torch.nn.functional.cross_entropy(whole.flatten(0, 1), labels.flatten())
    (dwhole,) = torch.autograd.grad(want, whole)
    V_l = whole.shape[-1] // n
    for r, res in enumerate(out):
        assert torch.equal(res["vocab"]["loss"], out[0]["vocab"]["loss"])
        torch.testing.assert_close(res["vocab"]["loss"], want.detach(), rtol=1e-6, atol=0)
        cols = dwhole[..., r * V_l:(r + 1) * V_l]
        err = (res["vocab"]["grad"] - cols).abs().max()
        assert err <= 1e-6 * cols.abs().max(), (r, float(err))


def jobs(calls: list) -> list:
    """Each (name of a function of this module, args) in turn on this
    rank, in one process group (one spawn serves several tests): their
    results."""
    return [globals()[name](*args) for name, args in calls]
