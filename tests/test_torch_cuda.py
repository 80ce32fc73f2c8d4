"""tuplex_tpu_torch on the card: the CUDA NFA scan against its plain torch
version, and the two pipelines through Context() on CUDA.

Every test here is marked `cuda` and skips without a GPU. This file
imports neither jax nor tuplex_tpu, so it runs on a GPU host without them:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Oracles: the plain version (`NFARegex.match_bitmask`) on the same CUDA
tensors, Python `re`, and a plain Python loop. Tolerance: exact.
"""

import re

import numpy as np
import pytest
import torch

import tuplex_tpu_torch
from tuplex_tpu_torch.models import logs
from tuplex_tpu_torch.ops import nfa as port_nfa
from tuplex_tpu_torch.ops import nfa_cuda

PATTERNS = ["abc", "a+b", "GET|POST", "a*b", "[0-9]+-[0-9]+", "^abc",
            "abc$", "^a.*b$", r"\d+", "(ab)+", "^$", "b$",
            r'" (4\d\d|5\d\d) ', "[ab]" * 64, r"[^a-z]\s?x{2,3}"]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _random_batch(seed: int, n: int, w: int):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ab cxGETPOS"45\n09z', dtype=np.uint8)
    mat = alphabet[rng.integers(0, len(alphabet), size=(n, w))]
    wide = rng.random(n) < 0.1
    mat[wide] = rng.integers(0, 256, size=(int(wide.sum()), w),
                             dtype=np.uint8)
    lens = rng.integers(0, w + 1, size=n).astype(np.int32)
    runs = rng.random(n) < 0.05
    mat[runs] = np.frombuffer(b"ab", dtype=np.uint8)[
        rng.integers(0, 2, size=(int(runs.sum()), w))]
    nl = (rng.random(n) < 0.2) & (lens > 0)
    mat[np.nonzero(nl)[0], lens[nl] - 1] = 10
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    return mat, lens


@pytest.mark.cuda
@pytest.mark.parametrize("w", [72, 75])     # 8-byte loads and byte loads
@pytest.mark.parametrize("pattern", PATTERNS)
def test_kernel_matches_plain_and_re(pattern, w, cuda_device):
    mat, lens = _random_batch(11, 1001, w)
    b = torch.from_numpy(mat).to(cuda_device)
    l = torch.from_numpy(lens).to(cuda_device)
    rx = port_nfa.compile_nfa(pattern)
    before = nfa_cuda.launches
    got = rx.match(b, l).cpu()
    assert torch.equal(got, rx.match_bitmask(b, l).cpu())
    assert nfa_cuda.launches == before + (1 if rx.n_pos else 0)
    rows = [bytes(r[:k]) for r, k in zip(mat, lens)]
    assert got.tolist() == [re.search(pattern.encode(), r) is not None
                            for r in rows]


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    t = port_nfa.compile_nfa("abc").tables
    b = torch.zeros((4, 8), dtype=torch.uint8, device=cuda_device)
    l = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        nfa_cuda.match_cuda(t, b, l.to(torch.int64))
    with pytest.raises(ValueError):
        nfa_cuda.match_cuda(t, b.t(), l)
    with pytest.raises(ValueError):
        nfa_cuda.match_cuda(t, b, l.cpu())


@pytest.mark.cuda
def test_pipelines_on_cuda(tmp_path, cuda_device):
    ctx = tuplex_tpu_torch.Context()
    assert ctx.device.type == "cuda"
    ds = ctx.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x))
    assert ds.collect() == [(1, 1), (2, 4), (4, 16)]
    assert ds.exception_counts() == {"TypeError": 1}
    path = str(tmp_path / "access.log")
    logs.generate_log(path, 5000, seed=17, non_ascii_every=1000)
    ctx = tuplex_tpu_torch.Context()
    before = nfa_cuda.launches
    assert logs.build_grep(ctx.text(path)).collect() == \
        logs.run_grep_reference(path)
    assert nfa_cuda.launches > before
    assert ctx.metrics.interpreterRows() == 5
