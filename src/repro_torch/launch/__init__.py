"""Launchers of the language-model side: the serving step functions
(:mod:`repro_torch.launch.steps`) and the batched generation loop
(:mod:`repro_torch.launch.serve`)."""
