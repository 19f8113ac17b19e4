"""The port's CUDA kernels on the card, against their plain twins.

Marked ``cuda``: each test skips with a reason where there is no usable
GPU (decided inside the fixture, never at import).  Run on a GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: proximity within 1e-3 degrees (the reference's ``TOL_DEG``);
tsgemm within rtol 1e-5 float32 / 2e-2 bfloat16, atol 10x rtol
(``tests/test_kernels.py``).
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


RANKS = [(p, q, m) for p, q in [(1, 1), (3, 3), (5, 5), (8, 8), (3, 5), (7, 2)]
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
