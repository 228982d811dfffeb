"""Numerics of the port: quantizers (``quantize``), bit-plane encodings
(``encoding``), the GeMM-based convolution (``conv``), the QuantLinear
projection (``qlinear``) and the quantization policies (``policy``)."""

from repro_torch.core import encoding, policy, quantize
from repro_torch.core.conv import check_conv_depth, conv2d_quantized, im2col
from repro_torch.core.policy import POLICIES, QuantPolicy
from repro_torch.core.qlinear import QuantLinear, linear_apply, linear_init
