"""The photonic execution model (``photonics``), the feedback matrices
(``feedback``), the energy model (``energy``) and the ``dfa`` alias.
Counterpart of ``repro/core``; only ``energy`` (pure Python) loads with the
package."""

from repro_torch.core import energy

__all__ = ["energy"]
