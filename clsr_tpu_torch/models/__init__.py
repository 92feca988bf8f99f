"""The ported models (CLSR only so far)."""
