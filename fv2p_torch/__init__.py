"""PyTorch/CUDA port of the FV2P LiDAR 3D detector.

Mirrors the layout of ``fv2p_tpu`` (the JAX reference package) module for
module. Plain tensor code is PyTorch; every Pallas kernel of the reference
is a hand-written CUDA kernel for Hopper (``ops/csrc``), built at first use
and bound with ``ctypes`` (``ops/cuda``). Entry point:
``fv2p_torch.models.build_network``.
"""
