"""EcoShift in PyTorch and CUDA: the port of the ``repro`` JAX package.

The layout mirrors ``repro`` (``core``, ``cluster``, ``kernels``,
``configs``, ``models``, ``serving``, ``launch``) so each module's
counterpart is easy to find.  The JAX package is the reference: the
port's tests hold each module against it, bit for bit on the control
round and within stated tolerances on the model zoo's serving path.

Entry points run on a CUDA card unless the caller passes
``device="cpu"``: ``device=None`` resolves to ``cuda`` and raises when no
card is present (:func:`repro_torch.device.resolve_device`).  The kernels
run as hand-written CUDA kernels on CUDA tensors and as their plain
PyTorch versions on CPU tensors: the dense (max,+) convolution
(``kernels/csrc/maxplus_conv.cu``), the fused round's sparse-option stage
(``kernels/csrc/maxplus_stage.cu``), and the serving path's RMSNorm,
prefill attention and decode attention (``kernels/csrc/rmsnorm.cu``,
``flash_attention.cu``, ``decode_attention.cu``).
"""
