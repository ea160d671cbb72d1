"""Compatibility alias — the DFA engine lives in ``repro_torch.algos``.
Counterpart of ``repro/core/dfa.py``.

The Eq. 1 engine is ``algos/dfa.py`` (registered as ``dfa`` /
``dfa-fused``), the backprop baseline is ``algos/bp.py`` (``bp``), and the
shallow ablation is ``algos/layerwise.py`` (``dfa-layerwise``).  This
module re-exports the historical ``core.dfa`` names; new code should go
through ``repro_torch.algos`` / ``repro_torch.api``::

    algo = algos.get("dfa")
    fn = algo.value_and_grad(model, cfg)          # was dfa.value_and_grad
    fb = algo.init_extra_state(model, seed, cfg)  # was dfa.init_feedback
    session = api.build_session(arch="mnist_mlp", algo="dfa", ...)
"""

from repro_torch.algos.bp import bp_value_and_grad
from repro_torch.algos.dfa import (
    DFAConfig,
    compress_error,
    freeze_norm_leaves,
    grad_alignment,
    init_feedback,
    make_fused_train_step,
    value_and_grad,
)

__all__ = [
    "DFAConfig", "bp_value_and_grad", "compress_error", "freeze_norm_leaves",
    "grad_alignment", "init_feedback", "make_fused_train_step",
    "value_and_grad",
]
