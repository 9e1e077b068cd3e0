"""Few-shot personalization serving — the paper's min-B step as an
online inference workload over a checkpointed, drifting representation.
Port of ``src/repro/serving/``.

Layers (bottom up):

  * :mod:`repro_torch.serving.engine`    — :class:`ServingEngine`, the
    packed batched min-B solve (one training-engine call per batch);
  * :mod:`repro_torch.serving.queue`     — deadline batcher + bounded
    queue + seeded closed-loop load (:func:`run_closed_loop`);
  * :mod:`repro_torch.serving.publisher` — U snapshots on the crash-safe
    checkpoint store, and the server's hot-swap reader.
"""
from repro_torch.serving.engine import ServingEngine, pack_requests
from repro_torch.serving.publisher import (HotSwapSource,
                                           RepresentationPublisher,
                                           deployable_basis,
                                           load_representation,
                                           publish_representation)
from repro_torch.serving.queue import (RequestGenerator, ServeRecord,
                                       ServeReport, ServeRequest,
                                       run_closed_loop)

__all__ = [
    "ServingEngine", "pack_requests",
    "RequestGenerator", "ServeRequest", "ServeRecord", "ServeReport",
    "run_closed_loop",
    "RepresentationPublisher", "HotSwapSource", "publish_representation",
    "load_representation", "deployable_basis",
]
