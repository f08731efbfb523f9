"""The compiler's front door (counterpart of the JAX package's
``homunculus`` facade, whose name stays the JAX package's), so an
Alchemy program reads like the paper's Figure 3::

    from repro_torch import facade
    from repro_torch.core.alchemy import DataLoader, Model, Platforms
    ...
    result = facade.generate(platform, budget=14, n_init=6, seed=0)

``generate`` trains on ``device`` (default ``"cuda"``) and compiles each
pipeline for the port's kernels there; ``device="cpu"`` runs the trainer
and the kernels' plain versions on the CPU.
"""

from repro_torch.core import alchemy
from repro_torch.core.chaining import compile_dag, run_dag
from repro_torch.core.dse import GenerationResult, generate, search_model

__all__ = [
    "alchemy", "generate", "search_model", "GenerationResult",
    "compile_dag", "run_dag",
]
