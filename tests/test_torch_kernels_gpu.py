"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (marker ``gpu``) and skips
without one; the file imports neither JAX nor the JAX package, so the
machine with the card runs it alone:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_gpu.py

All comparisons are ``torch.equal``: the kernels count the same integers
and are built with ``--fmad=false``, so the eq. (2) epilogue rounds as
the plain version does.
"""

import pytest
import torch

from repro_torch.core import encoding
from repro_torch.core.conv import pack_conv_filters
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bnn_matmul, tbn_matmul, tnn_matmul
from repro_torch.kernels.modes import QuantMode

pytestmark = pytest.mark.gpu

MODES = ["tnn", "tbn", "bnn"]
KERNELS = {"tnn": tnn_matmul, "tbn": tbn_matmul, "bnn": bnn_matmul}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _planes(vals: torch.Tensor, ternary: bool):
    return list(encoding.pack_ternary(vals)) if ternary else [encoding.pack_binary(vals)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(72, 24, 128), (360, 96, 512), (37, 21, 130),
                                   (1000, 130, 1152)])
def test_gemm_kernel_matches_plain(cuda_device, mode, shape):
    m, n, k = shape
    g = torch.Generator(device=cuda_device).manual_seed(m)
    a = torch.randint(-1, 2, (m, k), generator=g, device=cuda_device).float()
    b = torch.randint(-1, 2, (n, k), generator=g, device=cuda_device).float()
    ops_ = _planes(a, mode != "bnn") + _planes(b, mode == "tnn")
    row = torch.rand((m, 1), generator=g, device=cuda_device) + 0.5
    col = torch.rand((1, n), generator=g, device=cuda_device) + 0.5
    bias = torch.randn((1, n), generator=g, device=cuda_device)
    mod = KERNELS[mode]
    k_int = getattr(mod, f"{mode}_matmul_cuda")
    k_fused = getattr(mod, f"{mode}_matmul_fused_cuda")
    p_int = getattr(mod, f"{mode}_matmul_torch")
    p_fused = getattr(mod, f"{mode}_matmul_fused_torch")
    _build.reset_launches()
    assert torch.equal(k_int(*ops_, k), p_int(*ops_, k))
    assert torch.equal(k_fused(*ops_, k, row, col), p_fused(*ops_, k, row, col))
    assert torch.equal(k_fused(*ops_, k, row, col, bias), p_fused(*ops_, k, row, col, bias))
    assert _build.launches() == {f"lowbit_gemm_{mode}_i32": 1,
                                 f"lowbit_gemm_{mode}_fused": 2}


CONV_CASES = [((2, 8, 8, 32), (3, 3, 32, 16), 1, "SAME"),
              ((2, 7, 6, 8), (3, 3, 8, 70), 1, "SAME"),
              ((3, 9, 11, 40), (3, 3, 40, 7), 2, "VALID"),
              ((2, 10, 10, 64), (5, 5, 64, 33), 2, "SAME")]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv_kernel_matches_plain(cuda_device, mode, case):
    xs, fs, stride, padding = CONV_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(case)
    x = torch.randn(xs, generator=g, device=cuda_device)
    f = torch.randn(fs, generator=g, device=cuda_device)
    for bias in (None, torch.linspace(-1, 1, fs[-1], device=cuda_device)):
        qt = pack_conv_filters(f, QuantMode(mode), bias=bias)
        _build.reset_launches()
        got = ops.qconv(x, qt, stride=stride, padding=padding, backend="cuda")
        assert _build.launches() == {f"lowbit_conv_{mode}": 1}
        plain = ops.qconv(x, qt, stride=stride, padding=padding, backend="torch")
        assert torch.equal(got, plain)


def test_cuda_operands_never_run_plain(cuda_device):
    """A CUDA launch that the kernel refuses raises; nothing falls back."""
    a = torch.zeros((4, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        bnn_matmul.bnn_matmul_cuda(a, a, 64)


@pytest.mark.parametrize("mode", MODES)
def test_entry_points_on_card_match_plain(cuda_device, mode):
    """qmm / packed_matmul / PaperCNN through the registry: per-tensor
    scales arrive as expanded views and must reach the kernel intact."""
    from repro_torch.cnn import PaperCNN
    from repro_torch.configs.paper_cnn import PAPER_CNN_SMOKE

    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((50, 300), generator=g, device=cuda_device)
    qt = ops.pack_weights(torch.randn((300, 40), generator=g, device=cuda_device),
                          QuantMode(mode))
    _build.reset_launches()
    assert torch.equal(ops.qmm(x, qt), ops.qmm(x, qt, backend="torch"))
    xa = ops.quantize_activations(x, QuantMode(mode))
    assert torch.equal(ops.packed_matmul(xa, qt), ops.packed_matmul(xa, qt, backend="torch"))
    assert _build.launches() == {f"lowbit_gemm_{mode}_fused": 1, f"lowbit_gemm_{mode}_i32": 1}
    model = PaperCNN(PAPER_CNN_SMOKE, seed=1)
    plain = PaperCNN(PAPER_CNN_SMOKE, seed=1, backend="torch")
    imgs = torch.randn((3, 8, 8, 3), generator=g, device=cuda_device)
    assert torch.equal(model(imgs), plain(imgs))
