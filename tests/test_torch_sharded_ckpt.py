"""Port parity: the sharded checkpoint, ``ckpt.save_sharded`` / ``ckpt.restore_sharded``.

Ranks on a mesh write their training state as the file the reference's
``repro.ckpt.save(path, {"params": P, "opt_state": S}, step=...)`` writes
for the whole ``P`` (``lm.init_params``'s tree) and ``S`` (AdamW's state),
one rank writing a parameter at a time, and each rank reads back only its
slices.  At ``reduced()`` size, on gloo ranks in fresh processes (one
``run_ranks`` spawn of four: 2x2, then 1x2 on the first two), everything
exact:

* the reference writes a state, the ranks restore it on 2x2 ``fsdp_tp``
  (each piece the slice of the reference's array) and save it again: the
  two files hold the same keys in the same order, every array bit-equal
  (granite-8b; gemma3-4b's reduced stages include one with no
  super-block, written ``(0, ...)``);
* resume: per family, two steps uninterrupted against one step, save,
  restore into a fresh model and state, one step: the loss, every
  parameter, ``m``, ``v`` and ``step`` bit-equal (granite-8b 2x2
  ``fsdp_tp``; llama4-scout with 16 experts over ``model``, 2x2
  ``tp_only``; zamba2-7b 2x2 ``fsdp_tp``: Mamba2 parts, the shared block
  as FSDP pieces; whisper-medium 1x2: the encoder's stages; rwkv6-1.6b
  1x2);
* zero moments held as broadcast views are written as whole zeros; a
  model stored in bfloat16 as |V2 records, which the reference reads;
* each file is the ranks' pieces put together, and the reference's
  ``restore(path, like=...)`` reads it into its own ``init_params`` /
  ``adamw().init`` tree;
* a file saved at 2x2 ``fsdp_tp`` restores at 1x2 ``tp_only`` and
  unsharded (``ckpt.restore`` + ``lm_params_from_numpy``), each piece the
  ``local_slice`` of the written array;
* which rank's piece is written, on a ``("pod", "data", "model")`` mesh's
  coordinates (no processes);
* ``convert.lm_params_to_numpy`` refuses a rank's pieces.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_ckpt_ranks as ckpt_ranks
from _torch_tp_ranks import assemble, config
from repro import ckpt as ref_ckpt
from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch import ckpt, sharding
from repro_torch.convert import lm_layout, lm_params_from_numpy, lm_params_to_numpy, map_layout
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm

SPAWN_TIMEOUT_S = 300.0
REF_ARCHS = ("granite-8b", "gemma3-4b")
REF_STEP = 7
# (label, arch, experts, scheme): on 2x2, then on 1x2
QUAD = [("granite", "granite-8b", None, "fsdp_tp"),
        ("llama4", "llama4-scout-17b-a16e", 16, "tp_only"),
        ("zamba2", "zamba2-7b", None, "fsdp_tp")]
PAIR = [("whisper", "whisper-medium", None, "tp_only"),
        ("rwkv6", "rwkv6-1.6b", None, "tp_only")]
CASES = {label: (arch, experts, scheme, mesh) for mesh, cases in (("2x2", QUAD), ("1x2", PAIR))
         for label, arch, experts, scheme in cases}
RESHARD_FROM = "granite"


def _ref_config(arch, experts=None):
    cfg = ref_get_config(arch).reduced()
    return cfg if experts is None else dataclasses.replace(cfg, n_experts=experts)


def _ref_like(arch, experts=None) -> dict:
    """The reference's ``{"params", "opt_state"}`` tree of ``arch`` as
    shapes: ``init_params`` and ``adamw().init`` traced, nothing drawn."""
    cfg = _ref_config(arch, experts)
    opt = ref_optim.adamw(1e-3)
    return jax.eval_shape(lambda k: (lambda p: {"params": p, "opt_state": opt.init(p)})(
        ref_lm.init_params(cfg, k)), jax.random.PRNGKey(0))


def _ref_state(arch) -> dict:
    """The reference's ``init_params`` and AdamW state of ``arch``, the
    moments filled with seeded draws (not its zeros) and the step
    REF_STEP, as NumPy arrays."""
    cfg = _ref_config(arch)
    params = jax.tree.map(np.asarray, ref_lm.init_params(cfg, jax.random.PRNGKey(1)))
    state = jax.tree.map(np.asarray, ref_optim.adamw(1e-3).init(params))
    rng = np.random.default_rng(2)
    for k in ("m", "v"):
        state[k] = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) ** (
            2 if k == "v" else 1), state[k])
    state["step"] = np.int32(REF_STEP)
    return {"params": params, "opt_state": state}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's files, and every rank's results of the one spawn."""
    root = tmp_path_factory.mktemp("sharded_ckpt")
    ref_paths = {}
    for arch in REF_ARCHS:
        ref_paths[arch] = str(root / f"ref_{arch}")
        ref_ckpt.save(ref_paths[arch], _ref_state(arch), step=REF_STEP, config={"arch": arch})
    results = run_ranks(ckpt_ranks.ckpt_rank, 4, ref_paths, str(root), str(root), QUAD, PAIR,
                        RESHARD_FROM, backend="gloo", timeout=SPAWN_TIMEOUT_S,
                        store_dir=str(root))
    return {"root": root, "ref_paths": ref_paths, "ranks": results}


def _load(path) -> np.lib.npyio.NpzFile:
    return np.load(path / "arrays.npz")


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_reference_file_restores_and_saves_back_unchanged(run, arch):
    ref_path = run["root"] / f"ref_{arch}"
    port_path = run["root"] / f"port_{arch}"
    want, got = _load(ref_path), _load(port_path)
    assert list(got.files) == list(want.files)
    for key in want.files:
        assert _same(got[key], want[key]), key
    ref_meta = ref_ckpt.restore(ref_path)[1]
    meta = ckpt.restore(port_path)[1]
    assert meta["keys"] == ref_meta["keys"] and meta["step"] == REF_STEP
    assert meta["config"] == {"arch": arch}
    # the reference reads the port's file into its own tree
    back, _ = ref_ckpt.restore(port_path, like=_ref_like(arch))
    for key, arr in _flat(back).items():
        assert _same(arr, want[key]), key
    # each rank's pieces: the slice of the reference's arrays
    cfg = config(arch)
    plan = sharding.plan_for(cfg, "fsdp_tp")
    tree = _ref_state(arch)
    whole_model = lm_params_from_numpy(cfg, tree["params"], device="cpu")
    moments = {k: dict(lm_params_from_numpy(cfg, tree["opt_state"][k], device="cpu")
                       .named_parameters()) for k in ("m", "v")}
    for res in run["ranks"]:
        got = res[("reference", arch)]
        assert int(got["step"]) == REF_STEP and got["step"].dtype == torch.int32
        for name, p in whole_model.named_parameters():
            for what, whole in (("params", p), ("m", moments["m"][name]),
                                ("v", moments["v"][name])):
                want_piece = sharding.local_slice(whole.detach(), plan[name], res["coords"],
                                                  sharding.mamba_parts(cfg, name))
                assert torch.equal(got[what][name], want_piece), (what, name)


def test_zero_moments_held_as_views_are_written_whole(run):
    data = _load(run["root"] / "zero_views")
    want = _load(run["root"] / f"port_{REF_ARCHS[-1]}")
    assert list(data.files) == list(want.files)
    for key in want.files:
        if key.startswith("['opt_state']['m']") or key.startswith("['opt_state']['v']"):
            assert _same(data[key], np.zeros_like(want[key])), key
        elif key.startswith("['params']"):
            assert _same(data[key], want[key]), key


def test_bf16_model_round_trips_as_v2_records(run):
    cfg = config(ckpt_ranks.BF16_ARCH)
    whole = lm.init_params(cfg, seed=5, dtype=torch.bfloat16, device="cpu")
    named = dict(whole.named_parameters())

    def records(ref):      # the unsharded model's bits, stacked as the reference's leaf
        arrs = [ckpt._numpy(named[n]) for n in ref.names]
        return np.stack(arrs) if ref.stacked else arrs[0]

    want = {"['params']" + k: v
            for k, v in _flat(map_layout(records, lm_layout(cfg))).items()}
    data = _load(run["root"] / "bf16")
    assert any(a.dtype == np.dtype("V2") for a in want.values())
    for key, arr in want.items():
        assert _same(data[key], arr), key
    back, _ = ref_ckpt.restore(run["root"] / "bf16", like=_ref_like(ckpt_ranks.BF16_ARCH))
    for key, arr in _flat(back).items():
        assert _same(arr, data[key]), key
    for res in run["ranks"]:
        assert res["bf16_differ"] == []


@pytest.mark.parametrize("label", list(CASES))
def test_resume_is_bitwise(run, label):
    ranks = [res[label] for res in run["ranks"] if label in res]
    assert len(ranks) == (4 if CASES[label][3] == "2x2" else 2)
    for got in ranks:
        _, second, again = got["losses"]
        assert second == again and got["losses"] == ranks[0]["losses"]
        assert got["restored_differ"] == [] and got["resumed_differ"] == []
        assert got["meta_step"] == 1


@pytest.mark.parametrize("label", list(CASES))
def test_file_is_the_pieces_put_together(run, label):
    arch, experts, scheme, mesh = CASES[label]
    cfg = config(arch, experts)
    plan = sharding.plan_for(cfg, scheme)
    results = [res if mesh == "2x2" else dict(res, coords=res["pair_coords"])
               for res in run["ranks"] if label in res]
    data = _load(run["root"] / label)
    meta_model = lm.init_params(cfg, device="meta")
    want = {}
    for what in ("params", "m", "v"):
        whole, same = _assemble(cfg, plan, results, label, what)
        assert same, what
        prefix = "['params']" if what == "params" else f"['opt_state'][{what!r}]"
        want.update({prefix + k: v for k, v in
                     _flat(lm_params_to_numpy(meta_model, whole)).items()})
    want["['opt_state']['step']"] = np.asarray(results[0][label]["saved"]["step"].numpy())
    assert sorted(data.files) == sorted(want)
    for key, arr in want.items():
        assert _same(data[key], arr), key
    back, meta = ref_ckpt.restore(run["root"] / label, like=_ref_like(arch, experts))
    assert meta["step"] == 1
    for key, arr in _flat(back).items():
        assert _same(arr, want[key]), key


def _assemble(cfg, plan, results, label, what):
    """The whole of each leaf of ``what`` from the ranks' saved pieces."""
    rows = [{"coords": r["coords"], label: {what: r[label]["saved"][what]}} for r in results]
    return assemble(cfg, plan, rows, label, what)


def test_resharded_restore_is_the_written_slices(run):
    arch, experts, _, _ = CASES[RESHARD_FROM]
    cfg = config(arch, experts)
    plan = sharding.plan_for(cfg, "tp_only")
    tree, meta = ckpt.restore(run["root"] / RESHARD_FROM)
    assert meta["step"] == 1
    whole = {"params": lm_params_from_numpy(cfg, tree["params"], device="cpu")}
    whole.update({k: lm_params_from_numpy(cfg, tree["opt_state"][k], device="cpu")
                  for k in ("m", "v")})
    ranks = [res for res in run["ranks"] if "resharded" in res]
    assert len(ranks) == 2
    for res in ranks:
        got = res["resharded"]
        assert int(got["step"]) == int(tree["opt_state"]["step"]) == 1
        for what, model in whole.items():
            for name, p in model.named_parameters():
                want = sharding.local_slice(p.detach(), plan[name], res["pair_coords"],
                                            sharding.mamba_parts(cfg, name))
                assert torch.equal(got[what][name], want), (what, name)
    # unsharded: the port's own restore and converter give the written arrays back
    data = _load(run["root"] / RESHARD_FROM)
    for key, arr in _flat(lm_params_to_numpy(whole["params"])).items():
        assert _same(arr, data["['params']" + key]), key


def test_rank_coords_match_each_rank(run):
    for r, res in enumerate(run["ranks"]):
        assert res["rank_coords"][r] == res["coords"]


# which rank's piece is written: coordinates of a 2 x 2 x 2 ("pod", "data",
# "model") mesh, rank r at row-major position r, without processes
POD_COORDS = [{"pod": (p, 2), "data": (d, 2), "model": (m, 2)}
              for p in range(2) for d in range(2) for m in range(2)]


@pytest.mark.parametrize("arch,experts,scheme,name", [
    ("granite-8b", None, "fsdp_tp", "stages.0.0.sub0.attn.q"),
    ("granite-8b", None, "fsdp_tp", "stages.0.0.sub0.attn.o"),
    ("granite-8b", None, "tp_only", "embed"),
    ("granite-8b", None, "fsdp_tp", "final_norm"),
    ("granite-8b", None, "ddp", "lm_head"),
    ("llama4-scout-17b-a16e", 16, "fsdp_tp", "stages.0.0.sub0.moe.w_in"),
    ("zamba2-7b", None, "fsdp_tp", "stages.0.0.sub0.in_proj"),
])
def test_piece_writers_on_a_pod_mesh(arch, experts, scheme, name):
    cfg = config(arch, experts)
    spec = sharding.plan_for(cfg, scheme)[name]
    parts = sharding.mamba_parts(cfg, name)
    shape = tuple(sharding.meta_params(cfg)[name].shape)
    writers = sharding.piece_writers(spec, POD_COORDS)
    used = {a for e in spec for a in sharding._axes(e)}
    assert writers == [r for r, c in enumerate(POD_COORDS)
                       if c["pod"][0] == 0 and all(c[a][0] == 0 for a in ("data", "model")
                                                   if a not in used)]
    whole = torch.arange(np.prod(shape), dtype=torch.float64).reshape(shape)
    pieces = {r: sharding.local_slice(whole, spec, c, parts) for r, c in enumerate(POD_COORDS)}
    keys = [tuple(sharding._piece(e, POD_COORDS[r]) for e in spec) for r in writers]
    assert len(set(keys)) == len(keys)      # each piece once
    out = torch.full(shape, -1.0, dtype=torch.float64)
    for r in writers:
        sharding.place_slice(out, pieces[r], spec, POD_COORDS[r], parts)
    assert torch.equal(out, whole)          # and together the whole leaf
    for r, piece in pieces.items():         # every other rank's piece is a writer's
        assert any(torch.equal(piece, pieces[w]) for w in writers), r


@functools.lru_cache(maxsize=None)
def _rank_model(arch):
    cfg = config(arch)
    coords = {"data": (1, 2), "model": (1, 2)}
    lay = sharding.ShardLayout(cfg, sharding.plan_for(cfg, "fsdp_tp"), coords, None)
    return lay, lay.skeleton(torch.float32).to_empty(device="cpu")


@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-7b"])
def test_lm_params_to_numpy_refuses_pieces(arch):
    lay, rank = _rank_model(arch)
    with pytest.raises(ValueError, match="save_sharded"):
        lm_params_to_numpy(rank)
    whole = lm.init_params(config(arch), seed=0, dtype=torch.float32, device="cpu")
    pieces = {n: lay.local(n, p.detach()) for n, p in whole.named_parameters()}
    with pytest.raises(ValueError, match="save_sharded"):
        lm_params_to_numpy(whole, pieces)
    lm_params_to_numpy(whole, {n: p.detach() for n, p in whole.named_parameters()})
