"""Rank functions of tests/test_torch_tp_serve.py.

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
    the reference's weights serves its data group's rows; also a sharded
    model's refusal of train mode.  Returns the rank's coordinates and each
    case's :func:`_greedy` record."""
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
            try:
                lm.forward(params, batch["tokens"], mode="train")
                out[key]["train_refused"] = False
            except NotImplementedError:
                out[key]["train_refused"] = True
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
