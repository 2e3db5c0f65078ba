"""FailLite on PyTorch and CUDA, ported from the JAX package ``repro``:
the served models, the live failover testbed, the simulator's planning
and the experiment entry point (``python -m repro_torch``).

``repro_torch`` keeps the JAX package's module names (``models``,
``serving``, ``core``, ``kernels``, ``experiment``) so each piece has an
obvious counterpart, but imports neither ``jax`` nor anything from
``repro``. The control-plane modules it needs are copies, held against
their originals by ``tests/test_torch_control.py``.

Entry points (``experiment.run_experiment``, ``serving.testbed.
MiniTestbed``, ``models.model.init_params``, ``serving.engine.
InferenceEngine``, ``serving.server.WorkerServer``) run on ``cuda``
unless the caller passes ``device="cpu"``; see ``device.resolve_device``.
On a CUDA tensor the attention layers launch the hand-written kernels in
``kernels/``; on a CPU tensor they run the plain PyTorch versions.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
