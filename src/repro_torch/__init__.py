"""PyTorch/CUDA port of ``repro`` (Dif-AltGDmin, diffusion-based
decentralized federated multi-task representation learning).

Mirrors the JAX package module for module; the JAX package stays the
reference the port is tested against, and this package imports nothing
of it.  The entry point is :func:`repro_torch.api.run_experiment`, which
runs on the card unless asked for the CPU.
"""
