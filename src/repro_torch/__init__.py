"""EcoShift in PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro`` (``core``, ``cluster``, ``kernels``) so each
module's counterpart is easy to find.  The JAX package is the reference:
the port's tests hold each module against it bit for bit.

Entry points run on a CUDA card unless the caller passes
``device="cpu"``: ``device=None`` resolves to ``cuda`` and raises when no
card is present (:func:`repro_torch.device.resolve_device`).  The dense
(max,+) DP stage runs as a hand-written CUDA kernel
(``kernels/csrc/maxplus_conv.cu``) on CUDA tensors and as its plain
PyTorch version on CPU tensors.
"""
