"""EcoShift in PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro`` (``core``, ``cluster``, ``kernels``) so each
module's counterpart is easy to find.  The JAX package is the reference:
the port's tests hold each module against it bit for bit.

Entry points run on a CUDA card unless the caller passes
``device="cpu"``: ``device=None`` resolves to ``cuda`` and raises when no
card is present (:func:`repro_torch.device.resolve_device`).  The DP
stages run as hand-written CUDA kernels on CUDA tensors and as their plain
PyTorch versions on CPU tensors: the dense (max,+) convolution
(``kernels/csrc/maxplus_conv.cu``) and the fused round's sparse-option
stage (``kernels/csrc/maxplus_stage.cu``).
"""
