"""K1 on the card against its plain PyTorch version, variant by variant.

These tests need an NVIDIA GPU and the CUDA toolkit (a CUDA kernel has no
CPU mode) and skip without them.  The file imports torch only, so it also
runs on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from lotus_tpu_torch.ops import ivf_probe as tprobe


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,metric,int8_dot,packed",
    [
        (torch.int8, "ip", True, True),
        (torch.bfloat16, "ip", False, True),
        (torch.int8, "ip", False, True),
        (torch.float32, "ip", False, False),
        (torch.bfloat16, "l2", False, False),
        (torch.int8, "ip", True, False),
    ],
)
def test_kernel_matches_plain_version_on_gpu(dtype, metric, int8_dot, packed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 has no CPU mode")
    g = torch.Generator().manual_seed(0)
    d, bl, nlist = 64, 1024, 6
    sizes = torch.tensor([3000, 0, 1024, 17, 2100, 900], dtype=torch.int32)
    padded = torch.clamp((sizes + bl - 1) // bl, min=1) * bl
    starts = (torch.cumsum(padded, 0) - padded).to(torch.int32)
    rows = int(padded.sum())
    xf = torch.randn((rows, d), generator=g)
    x = torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8) if dtype == torch.int8 else xf.to(dtype)
    chunk_list = torch.tensor([0, 2, 2, 3, 4, 5, 1, -1, -1], dtype=torch.int32)
    if int8_dot:
        q = torch.randint(-127, 128, ((len(chunk_list) - 1) * 128, d), generator=g, dtype=torch.int8)
    else:
        q = torch.randn(((len(chunk_list) - 1) * 128, d), generator=g).to(
            torch.float32 if dtype == torch.float32 else torch.bfloat16)
    scales = torch.rand(rows, generator=g) + 0.5 if dtype == torch.int8 else None
    norms = torch.rand(rows, generator=g) if metric == "l2" else None
    args = (q, x, scales, norms, chunk_list, starts, sizes)
    ref_s, ref_i = tprobe.probe_fold_reference(*args, bl=bl, int8_dot=int8_dot, l2=metric == "l2", packed=packed)
    cuda_args = [None if t is None else t.cuda() for t in args]
    got_s, got_i = tprobe.probe_fold(*cuda_args, bl=bl, int8_dot=int8_dot, l2=metric == "l2", packed=packed)
    torch.cuda.synchronize()
    if int8_dot:  # exact integer dot products: bit for bit, ids included
        torch.testing.assert_close(got_s.cpu().view(torch.int32), ref_s.view(torch.int32), rtol=0, atol=0)
        if not packed:
            torch.testing.assert_close(got_i.cpu(), ref_i, rtol=0, atol=0)
        return
    # Float sums run in another order; packed scores keep ~10 mantissa bits.
    tol = 2e-3 if packed else 1e-4
    got, ref = got_s.cpu(), ref_s
    if packed:
        got = (got.view(torch.int32) & ~tprobe._LOCAL_MASK).view(torch.float32)
        ref = (ref.view(torch.int32) & ~tprobe._LOCAL_MASK).view(torch.float32)
    torch.testing.assert_close(got, ref, rtol=tol, atol=1e-3)
