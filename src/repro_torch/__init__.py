"""PyTorch port of the EF-signSGD system (``repro``), for one NVIDIA H100.

Module names mirror ``src/repro/`` so each part has an obvious counterpart
there; the JAX package is the reference the port is tested against. This
package imports ``torch``, ``numpy`` and the standard library only — never
``jax`` and nothing of ``repro``.
"""
