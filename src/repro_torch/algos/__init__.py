"""Pluggable training algorithms.  Counterpart of ``repro/algos``.

Built-in registrations (import side effect of the submodules below):

* ``bp``            — exact backprop baseline (algos/bp.py)
* ``dfa``           — the paper's Eq. 1 engine (algos/dfa.py)
* ``dfa-fused``     — same gradients, update fused into the per-block backward
* ``dfa-layerwise`` — per-layer error tap, the shallow-DFA ablation
  (algos/layerwise.py)
"""

from repro_torch.algos.base import Algorithm, get, list_algos, register
from repro_torch.algos import bp, dfa, layerwise  # noqa: F401  (register built-ins)
from repro_torch.algos.dfa import DFAConfig

__all__ = ["Algorithm", "DFAConfig", "get", "list_algos", "register", "bp", "dfa",
           "layerwise"]
