"""Launchers (counterpart of ``repro.launch``): the training and serving
entry points (``train``, ``serve``; each runnable with ``python -m``),
abstract inputs on the meta device (``specs``), mesh construction
(``mesh``) and multi-process bring-up (``multihost``)."""
