"""Launchers of the language-model side: the step functions of the
trainer and the server (:mod:`repro_torch.launch.steps`), decentralized
training (:mod:`repro_torch.launch.train`) and the batched generation
loop (:mod:`repro_torch.launch.serve`)."""
