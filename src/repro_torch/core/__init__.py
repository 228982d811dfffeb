"""Numerics of the port: quantizers (``quantize``), bit-plane encodings
(``encoding``) and the GeMM-based convolution (``conv``)."""
