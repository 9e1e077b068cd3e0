"""CLI front-end for :mod:`repro_torch.analysis` — see ``__main__.py``."""
