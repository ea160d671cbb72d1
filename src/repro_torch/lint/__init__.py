"""``repro_torch.lint`` — the runtime sanitizers (``lint.runtime``).  The
reference's static rules RL001–RL005 check JAX idioms and have no
counterpart here."""
