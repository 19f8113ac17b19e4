"""The port's CUDA kernels on the card, against their plain twins.

Marked ``cuda``: each test skips with a reason where there is no usable
GPU (decided inside the fixture, never at import).  Run on a GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: proximity within 1e-3 degrees (the reference's ``TOL_DEG``);
tsgemm within rtol 1e-5 float32 / 2e-2 bfloat16, atol 10x rtol
(``tests/test_kernels.py``); flash attention within 2e-5 float32 / 3e-2
bfloat16 (``tests/test_kernels.py``); WKV within 1e-5 of the largest
|output| and |state| (the state barely decays, so the scale grows with S).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL_DEG = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on a GPU")
    return torch.device("cuda")


def _signatures(K, n, p, seed, spread=None):
    rng = np.random.default_rng(seed)
    if spread is None:
        X = rng.normal(size=(K, n, p))
    else:
        X = rng.normal(size=(n, p))[None] + spread / np.sqrt(n) * rng.normal(size=(K, n, p))
    return torch.from_numpy(np.stack([np.linalg.qr(x)[0] for x in X]).astype(np.float32))


RANKS = [(p, q, m) for p, q in [(1, 1), (3, 3), (5, 5), (8, 8), (3, 5), (7, 2),
                                 (9, 9), (12, 12), (3, 12), (12, 5)]
         for m in ("eq3", "eq2") if m == "eq2" or p == q]


@pytest.mark.parametrize("p,q,measure", RANKS)
@pytest.mark.parametrize("Ka,Kb", [(13, 13), (70, 5), (1, 33)])
def test_proximity_kernel_matches_plain(cuda, Ka, Kb, p, q, measure):
    from repro_torch.kernels import _build
    from repro_torch.kernels.proximity import proximity_cuda, proximity_plain

    Ua = _signatures(Ka, 200, p, seed=Ka + p, spread=0.3).to(cuda)
    Ub = _signatures(Kb, 200, q, seed=Kb + q + 1, spread=0.3).to(cuda)
    before = _build.LAUNCHES["proximity"]
    got = proximity_cuda(Ua, Ub, measure)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["proximity"] == before + 1
    want = proximity_plain(Ua, Ub, measure)
    assert got.shape == (Ka, Kb) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_DEG


def test_proximity_backends_on_cuda_go_through_the_kernel(cuda):
    from repro_torch.core import angles
    from repro_torch.kernels import _build

    U = _signatures(20, 64, 3, seed=0).to(cuda)
    before = _build.LAUNCHES["proximity"]
    A = angles.proximity_matrix(U, "eq3")
    # distinct clients only: a self-pair sits at G = I, where one float32
    # ulp of the Gram is already 0.02 degrees under arccos
    C = angles.cross_proximity(U[4:], U[:4], "eq2")
    assert _build.LAUNCHES["proximity"] == before + 2
    ref = angles.proximity_matrix(U.cpu(), "eq3", backend="torch")
    assert (A.cpu() - ref).abs().max().item() <= TOL_DEG
    assert (A == A.T).all() and (A.diagonal() == 0).all()
    ref_c = angles.cross_proximity(U[4:].cpu(), U[:4].cpu(), "eq2", backend="torch")
    assert (C.cpu() - ref_c).abs().max().item() <= TOL_DEG


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,m,k,p,transpose_a", [
    (1, 128, 128, 8, False), (3, 512, 300, 10, True), (2, 1000, 768, 13, False),
    (4, 50, 40, 3, True), (2, 11, 700, 300, False), (5, 257, 33, 20, True),
])
def test_tsgemm_kernel_matches_plain(cuda, Bt, m, k, p, transpose_a, dtype):
    from repro_torch.kernels.tsgemm import tsgemm_cuda, tsgemm_plain

    g = torch.Generator(device=cuda).manual_seed(m + k + p)
    if transpose_a:
        A = torch.randn((Bt, k, m), generator=g, device=cuda).to(dtype).transpose(1, 2)
    else:
        A = torch.randn((Bt, m, k), generator=g, device=cuda).to(dtype)
    B = torch.randn((Bt, k, p), generator=g, device=cuda).to(dtype)
    got = tsgemm_cuda(A, B)
    want = tsgemm_plain(A, B)
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=rtol, atol=10 * rtol)


def test_pipeline_on_cuda_matches_cpu(cuda):
    from repro_torch.core.pacfl import PACFLConfig, one_shot_clustering
    from repro_torch.kernels import _build
    from repro_torch.serving import RepresentativeCache, serve_assign

    rng = np.random.default_rng(0)
    n, p = 64, 3
    bases = [np.linalg.qr(rng.normal(size=(n, p)))[0] for _ in range(3)]
    data = []
    for k in range(18):
        Bk = np.linalg.qr(bases[k % 3] + 0.1 / np.sqrt(n) * rng.normal(size=(n, p)))[0]
        M = int(rng.integers(30, 90))
        coef = np.array([8.0, 3.0, 1.0])[:, None] * rng.normal(size=(p, M))
        data.append((Bk @ coef + 0.02 * rng.normal(size=(n, M))).astype(np.float32))
    cfg = PACFLConfig(p=p, beta=60.0, svd_method="exact")
    _build.reset_launches()
    gpu = one_shot_clustering(data, cfg, device=cuda)
    cpu = one_shot_clustering(data, cfg, device="cpu")
    assert _build.LAUNCHES["proximity"] >= 1
    np.testing.assert_array_equal(gpu.labels, cpu.labels)
    assert gpu.U.device.type == "cuda"
    ext = gpu.extend(gpu.U[:2].clone())
    cache = RepresentativeCache("medoid")
    cache.refresh(ext.engine)
    idx, d = serve_assign(gpu.U[:6], cache.rep_stack, "eq3")
    assert idx.device.type == "cuda" and torch.isfinite(d).all()


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, hd, causal, window, q_offset
    (2, 64, 64, 4, 2, 32, True, None, 0),
    (1, 32, 128, 8, 8, 16, False, None, 0),
    (2, 64, 64, 4, 1, 32, True, 16, 0),
    (1, 16, 64, 4, 2, 32, True, None, 48),
    (1, 128, 128, 2, 2, 64, True, None, 0),
    (3, 32, 32, 6, 3, 32, True, 8, 0),
    (2, 200, 200, 32, 4, 64, True, None, 0),        # tinyllama heads, ragged tiles
    (4, 1, 1056, 32, 4, 64, True, None, 1040),      # decode against a cache
    (2, 13, 77, 8, 2, 64, True, 20, 60),            # ragged Sq and Skv, window
    (1, 5, 40, 4, 4, 128, False, 7, 50),            # rows with no valid key
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd,causal,window,qoff", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, Hq, Hkv, hd, causal,
                                              window, qoff, dtype):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(Sq * 7 + Skv)
    q = torch.randn((B, Sq, Hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=g, device=cuda).to(dtype)
    before = _build.LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=qoff)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=qoff)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,hd", [(2, 16, 4, 16), (1, 40, 2, 32), (3, 7, 1, 16),
                                      (2, 300, 8, 64), (4, 1, 32, 64), (1, 33, 2, 128)])
def test_wkv_kernel_matches_plain(cuda, B, S, H, hd, with_state):
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_cuda, wkv_plain

    g = torch.Generator(device=cuda).manual_seed(B * 100 + S)
    r, k, v = (torch.randn((B, S, H, hd), generator=g, device=cuda) for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=g, device=cuda))
    u = 0.1 * torch.randn((H, hd), generator=g, device=cuda)
    s0 = torch.randn((B, H, hd, hd), generator=g, device=cuda) if with_state else None
    before = _build.LAUNCHES["wkv"]
    out, sT = wkv_cuda(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["wkv"] == before + 1
    want_out, want_s = wkv_plain(r, k, v, w, u, s0)
    assert (out - want_out).abs().max().item() <= 1e-5 * want_out.abs().max().item()
    assert (sT - want_s).abs().max().item() <= 1e-5 * want_s.abs().max().item()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-1.6b"])
def test_lm_serving_on_cuda_matches_cpu(cuda, arch):
    """Reduced model in float32: the kernels on the card against the plain
    twins on the CPU, prefill and 4 decode steps, one launch per layer per
    forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    gpu = lm.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    prompt = serve.random_prompt(cfg, 2, 24, seed=0, device=cuda)
    name = "wkv" if cfg.block_kind == "rwkv6" else "flash_attention"
    _build.reset_launches()
    toks, _ = serve.generate(gpu, prompt, 5)
    assert _build.LAUNCHES[name] == cfg.n_layers * 5
    with torch.inference_mode():
        got, _ = lm.forward(gpu, prompt)
        cpu = gpu.to("cpu")
        want, _ = lm.forward(cpu, prompt.cpu())
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    assert toks.shape == (2, 5)
