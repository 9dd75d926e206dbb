"""PyTorch port of the ASD (autospeculative decoding) sampler for CUDA.

Laid out module for module like the JAX package ``repro``: ``configs``,
``core`` (schedules, GRS, verifier, controller, ASD), ``nn`` and ``models``
(the DiT-style denoiser), ``kernels`` (hand-written CUDA kernels with their
plain PyTorch versions beside them, sources in ``csrc/``) and ``weights``.
The port imports nothing of ``repro``: what it needs is copied here.
"""
