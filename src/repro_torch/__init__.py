"""FailLite on PyTorch and CUDA: the served-model path, ported from the
JAX package ``repro``.

``repro_torch`` keeps the JAX package's module names (``models``,
``serving``, ``core``, ``kernels``) so each piece has an obvious
counterpart, but imports neither ``jax`` nor anything from ``repro``.
The control-plane modules it needs (variants, heartbeat, router) are
copies, held against their originals by ``tests/test_torch_control.py``.

Entry points (``models.model.init_params``, ``serving.engine.
InferenceEngine``, ``serving.server.WorkerServer``) run on ``cuda``
unless the caller passes ``device="cpu"``; see ``device.resolve_device``.
On a CUDA tensor the attention layers launch the hand-written kernels in
``kernels/``; on a CPU tensor they run the plain PyTorch versions.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
