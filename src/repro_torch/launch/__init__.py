"""Launchers of the language-model side: the step functions of the
trainer and the server (:mod:`repro_torch.launch.steps`), decentralized
training (:mod:`repro_torch.launch.train`), the batched generation loop
(:mod:`repro_torch.launch.serve`), and the production layouts with their
dry run on the meta device: the input shapes
(:mod:`~repro_torch.launch.shapes`), the meshes and the card's roofline
constants (:mod:`~repro_torch.launch.mesh`), the sharding rules
(:mod:`~repro_torch.launch.sharding`), the abstract inputs
(:mod:`~repro_torch.launch.specs`) and the dry run itself
(:mod:`~repro_torch.launch.dryrun`)."""
