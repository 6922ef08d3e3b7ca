"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device, so the CPU suite
counts none of them.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports nothing of JAX, so it runs where only PyTorch is
installed.  Tolerances: 2e-5 for f32 (the same products summed in another
order), 2e-2 for f16/bf16 (one rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa            # noqa: E402


def _qkv(B, H, KV, Sq, Sk, dh, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, H, Sq, dh)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, dh)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, dh)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dt = getattr(torch, dtype)
    for (B, H, KV, Sq, Sk, dh, causal) in [(1, 24, 8, 512, 512, 128, True),
                                           (2, 4, 2, 100, 100, 64, False),
                                           (1, 4, 4, 48, 130, 32, True)]:
        q, k, v = (torch.as_tensor(x).to("cuda", dt)
                   for x in _qkv(B, H, KV, Sq, Sk, dh, seed=5))
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        want = fa.attention_plain(q, k, v, causal=causal)
        tol = 2e-5 if dtype == "float32" else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
