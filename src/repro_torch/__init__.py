"""PyTorch + CUDA port of the Homunculus serving stack for NVIDIA Hopper.

A second package beside the JAX reference (``repro``).  It imports
``torch``, ``numpy`` and the standard library only — never ``jax``,
``repro`` or ``homunculus`` — and mirrors the reference's layout so each
module has a named counterpart:

  ``flowstate/``   per-flow register files (one table or several) +
                   ``StatefulPipeline``
  ``core/``        stage IR and ``compile_stages``, the CUDA lowering
                   (``cuda_backend``), the Alchemy front end and DAG
                   vocabulary (``alchemy``), ``chaining.compile_dag``,
                   and the compiler: trainers (``mlalgos``), design
                   spaces, surrogate and BO, the candidate cache,
                   feasibility models, ``codegen`` and ``dse``
  ``facade.py``    ``generate`` and friends, as the JAX package's
                   ``homunculus`` exports them
  ``kernels/``     hand-written CUDA C++ kernels (``csrc/``) beside their
                   plain PyTorch versions (``ref.py``)
  ``serve/``       ``PacketServeEngine``; the LM ``ServeEngine`` and its
                   prefill/decode steps
  ``configs/``     ``ModelConfig`` and the dense LM family's configs
  ``models/``      the LM stack: layers, attention and KV caches, the
                   decoder forward, the parameter registry
  ``telemetry/``   the serving engine's observability plane (numpy only)
  ``data/``        seeded packet streams and datasets (numpy only)
  ``convert.py``   carries stage lists, register state, DAGs, named
                   pipelines and LM parameter trees across from the
                   reference package without importing it

Device rule: every entry point takes ``device`` (default ``"cuda"``) and
raises when CUDA is asked for and no GPU exists; the compiler trains
and serves there too.  A kernel op launches its
CUDA kernel for CUDA tensors and runs its plain version for CPU tensors;
there is no other switch and no fallback.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
